#!/bin/sh
# MODE-switch entrypoint of the PyTorch/CUDA port (vqvaehmm_tpu_torch):
# MODE=train|serve|serve-prod|serve-asgi, as entrypoint.sh, on the card.
# Arguments go to the end of the command (training overrides such as
# training.num_epochs=2, or a server's flags).
exec python3 -m vqvaehmm_tpu_torch.entrypoint "$@"
