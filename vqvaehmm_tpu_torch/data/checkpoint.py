"""Weights across the two packages: the JAX parameter pytree <-> state_dict.

The JAX package keeps its parameters in torch's layouts already (Conv1d
(O, I, W), Linear (out, in)), so crossing over is a renaming and no
transpose.  Its `.npz` files hold flat `/`-joined keys
(`encoder/conv1/weight`); the port's modules use the reference's
state_dict keys (`encoder.conv1.weight`), so a reference `.pt` file loads
into them directly.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# JAX pytree path -> state_dict key, for VAEHMM and for the
# RegimePortfolioOptimizer head (whose reference keys are net.{0,2,4}).
_PARAM_MAP = {
    "encoder/conv1/weight": "encoder.conv1.weight",
    "encoder/conv1/bias": "encoder.conv1.bias",
    "encoder/conv2/weight": "encoder.conv2.weight",
    "encoder/conv2/bias": "encoder.conv2.bias",
    "encoder/to_logits/weight": "encoder.to_logits.weight",
    "encoder/to_logits/bias": "encoder.to_logits.bias",
    "prior/log_prior": "prior.log_prior",
    "prior/fc1/weight": "prior.transition_net.0.weight",
    "prior/fc1/bias": "prior.transition_net.0.bias",
    "prior/fc2/weight": "prior.transition_net.2.weight",
    "prior/fc2/bias": "prior.transition_net.2.bias",
    "decoder/embeddings/weight": "decoder.embeddings.weight",
    "decoder/conv1/weight": "decoder.conv1.weight",
    "decoder/conv1/bias": "decoder.conv1.bias",
    "decoder/conv2/weight": "decoder.conv2.weight",
    "decoder/conv2/bias": "decoder.conv2.bias",
    "decoder/to_params/weight": "decoder.to_params.weight",
    "decoder/to_params/bias": "decoder.to_params.bias",
    "fc1/weight": "net.0.weight",
    "fc1/bias": "net.0.bias",
    "fc2/weight": "net.2.weight",
    "fc2/bias": "net.2.bias",
    "fc3/weight": "net.4.weight",
    "fc3/bias": "net.4.bias",
}
_INVERSE = {v: k for k, v in _PARAM_MAP.items()}


def _flatten(prefix: str, tree) -> Dict[str, np.ndarray]:
    if not isinstance(tree, Mapping):
        return {prefix: tree}
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(_flatten(f"{prefix}/{k}" if prefix else str(k), v))
    return out


def params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (numpy arrays; nested dicts as
    `load_params_npz` returns them, or flat `encoder/conv1/weight` keys)
    -> a float32 state_dict for the port's modules."""
    flat = _flatten("", tree)
    unknown = sorted(set(flat) - set(_PARAM_MAP))
    if unknown:
        raise KeyError(f"unrecognised parameter paths: {unknown}")
    return {_PARAM_MAP[k]: torch.from_numpy(
                np.array(v, dtype=np.float32, copy=True))
            for k, v in flat.items()}


def params_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of params_from_numpy: a state_dict -> the JAX package's
    nested parameter pytree of numpy arrays."""
    out: Dict = {}
    for key, v in state_dict.items():
        if key not in _INVERSE:
            raise KeyError(f"unrecognised state_dict key: {key!r}")
        node = out
        *parents, leaf = _INVERSE[key].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return out


def load_params_npz(path: str) -> Dict:
    """A flat-npz parameter file (keys `/`-joined, as the JAX package's
    save_params_npz writes them) -> nested dict of numpy arrays."""
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pt`/`.pth` state_dict file, read with
    weights_only=True (no arbitrary unpickling)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, Mapping):
        raise ValueError(f"{path} does not hold a state_dict")
    return dict(state)


def validate_params_for(module: torch.nn.Module,
                        state_dict: Mapping[str, torch.Tensor],
                        what: str = "checkpoint") -> None:
    """Raise ValueError naming the mismatched keys if `state_dict` cannot
    belong to `module`.  Servers call it at start-up, so a config that
    does not match its checkpoint fails there, not as request-time 500s."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    bad = [f"{k}: missing (template {want[k]})"
           for k in sorted(want.keys() - got.keys())]
    bad += [f"{k}: unexpected (checkpoint {got[k]})"
            for k in sorted(got.keys() - want.keys())]
    bad += [f"{k}: checkpoint {got[k]} vs template {want[k]}"
            for k in sorted(want.keys() & got.keys()) if got[k] != want[k]]
    if bad:
        raise ValueError(
            f"{what} params do not match the configured model (wrong model "
            "config?); mismatched leaves:\n  " + "\n  ".join(bad[:5]))
