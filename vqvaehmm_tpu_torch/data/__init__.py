from .checkpoint import (improved_head_params_from_numpy,
                         load_improved_head, load_params_npz,
                         load_state_dict_file, params_from_numpy,
                         params_to_numpy, validate_params_for)
