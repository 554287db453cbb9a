"""Weights across the two packages, and training checkpoints.

The JAX package keeps its parameters in torch's layouts already (Conv1d
(O, I, W), Linear (out, in)), so crossing over is a renaming and no
transpose.  Its `.npz` files hold flat `/`-joined keys
(`encoder/conv1/weight`); the port's modules use the reference's
state_dict keys (`encoder.conv1.weight`), so a reference `.pt` file loads
into them directly.

The VQ family's parameters (models/vqvae_hmm.py) cross by the same
renaming (`vq_params_from_numpy`, `vq_params_to_numpy`).  Its archive
`vq_stack.npz` holds them as `vq_0..vq_12`, the leaves of the JAX pytree
in `jax.tree_util.tree_flatten` order, which sorts dictionary keys:
`VQ_LEAF_ORDER` is that order in state_dict keys.

A reference portfolio head (`.pt`) loads through `load_head_file`, its
family told from the state_dict's naming.  An Improved head the port
trains is written in the JAX package's stacked layout through
`head_params_to_numpy`; a hedger's, another head's or a regime model's
JAX pytree crosses through `zoo_params_from_numpy`.

A training checkpoint (save_checkpoint) holds the model, the Adam state
and the step, so a run resumes exactly; it is the port's own format
(torch.save), with the JAX package's `.meta.json` sidecar beside it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

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


_IMPROVED_HEAD_KEYS = tuple(f"fc{i}/{leaf}" for i in (1, 2, 3)
                            for leaf in ("weight", "bias"))


def improved_head_params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's ImprovedPortfolioOptimizer pytree (the K experts
    stacked: fc{1,2,3}/{weight (K, out, in), bias (K, out)}) -> a float32
    state_dict for the port's module.  The sibling of params_from_numpy,
    which reads the same `fc*` paths as the unstacked
    RegimePortfolioOptimizer."""
    flat = _flatten("", tree)
    if sorted(flat) != sorted(_IMPROVED_HEAD_KEYS) or any(
            np.ndim(flat[f"fc{i}/weight"]) != 3 for i in (1, 2, 3)):
        shapes = {k: np.shape(v) for k, v in sorted(flat.items())}
        raise KeyError("not a stacked ImprovedPortfolioOptimizer pytree: "
                       f"paths and shapes {shapes}")
    return {k.replace("/", "."): torch.from_numpy(
                np.array(v, dtype=np.float32, copy=True))
            for k, v in flat.items()}


def load_improved_head(path: str, device="cuda"):
    """An ImprovedPortfolioOptimizer in eval() mode on `device`, sized by
    and loaded from a stacked-pytree `.npz` (artifacts/portfolio_head.npz)."""
    from ..core.device import resolve_device
    from ..models.portfolio import HeadConfig, ImprovedPortfolioOptimizer

    state = improved_head_params_from_numpy(load_params_npz(path))
    K, hidden, _ = state["fc1.weight"].shape
    head = ImprovedPortfolioOptimizer(
        HeadConfig(K=K, n_assets=state["fc3.weight"].shape[1],
                   hidden_dim=hidden), device=resolve_device(device))
    validate_params_for(head, state, what=f"head checkpoint {path!r}")
    head.load_state_dict(state)
    return head.eval()


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


# jax.tree_util.tree_flatten of {"encoder": {conv1, conv2, to_latent},
# "codebook", "decoder": {conv1, conv2, to_out}}, each conv {weight, bias}:
# keys sorted at every level
VQ_LEAF_ORDER = ("codebook",) + tuple(
    f"{part}.{conv}.{leaf}"
    for part, last in (("decoder", "to_out"), ("encoder", "to_latent"))
    for conv in ("conv1", "conv2", last) for leaf in ("bias", "weight"))


def vq_params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """The JAX package's VQVAEHMM pytree (nested dicts of numpy arrays, or
    the archive's list of leaves in VQ_LEAF_ORDER) -> a float32 state_dict
    for the port's VQVAEHMM."""
    if isinstance(tree, Mapping):
        flat = {k.replace("/", "."): v for k, v in _flatten("", tree).items()}
    else:
        leaves = list(tree)
        if len(leaves) != len(VQ_LEAF_ORDER):
            raise ValueError(f"{len(leaves)} arrays given but a VQVAEHMM "
                             f"has {len(VQ_LEAF_ORDER)}")
        flat = dict(zip(VQ_LEAF_ORDER, leaves))
    unknown = sorted(set(flat) ^ set(VQ_LEAF_ORDER))
    if unknown:
        raise KeyError(f"not a VQVAEHMM pytree; unmatched paths: {unknown}")
    return {k: torch.from_numpy(np.array(flat[k], dtype=np.float32,
                                         copy=True)) for k in VQ_LEAF_ORDER}


def vq_params_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of vq_params_from_numpy: the JAX package's nested pytree of
    numpy arrays, its dictionaries in sorted-key order, so that its leaves
    read in order are the archive's `vq_i`."""
    out: Dict = {}
    for key in VQ_LEAF_ORDER:
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = state_dict[key].detach().cpu().numpy()
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


def save_params_npz(path: str, params: Mapping) -> None:
    """Write parameters as the JAX package's flat-npz parameter file
    (`/`-joined pytree paths, save_params_npz's layout), so either package
    loads the other's trained weights.  `params` is a state_dict of the
    VAE-HMM or the RegimePortfolioOptimizer head, or a pytree of numpy
    arrays (nested dicts, as head_params_to_numpy returns for the
    Improved head)."""
    tree = params
    if any(isinstance(v, torch.Tensor) for v in params.values()):
        tree = params_to_numpy(params)
    flat = _flatten("", tree)
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def head_params_to_numpy(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Inverse of improved_head_params_from_numpy: an
    ImprovedPortfolioOptimizer's state_dict -> the JAX package's stacked
    pytree fc{1,2,3}/{weight (K, out, in), bias (K, out)} of numpy arrays,
    the layout of artifacts/portfolio_head.npz."""
    keys = {k.replace("/", ".") for k in _IMPROVED_HEAD_KEYS}
    if set(state_dict) != keys or any(
            state_dict[f"fc{i}.weight"].dim() != 3 for i in (1, 2, 3)):
        raise KeyError("not an ImprovedPortfolioOptimizer state_dict: keys "
                       f"{sorted(state_dict)}")
    out: Dict = {}
    for key, v in state_dict.items():
        layer, leaf = key.split(".")
        out.setdefault(layer, {})[leaf] = v.detach().cpu().numpy()
    return out


def zoo_params_from_numpy(tree, module: Optional[torch.nn.Module] = None
                          ) -> Dict[str, torch.Tensor]:
    """A downstream model's JAX pytree -> a float32 state_dict for the
    port's module of the same class: the heads of models/portfolio.py
    (the ensemble's stacked members included), the models of
    models/regime.py and the hedgers.  Paths map by name (`fc1/weight` ->
    `fc1.weight`); an `lstm` layer list becomes nn.LSTM's
    `lstm.weight_ih_l{i}`, ..., and any other list (the transformer's
    `encoder`) is indexed (`encoder.0.self_attn.in_proj_weight`).  With
    `module` given, the keys and shapes are checked against it."""
    from ..ops.rnn import lstm_state_from_numpy

    def walk(prefix: str, node, out: Dict[str, torch.Tensor]) -> None:
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v, out)
        elif isinstance(node, (list, tuple)):
            if prefix.endswith("lstm."):
                out.update(lstm_state_from_numpy(node, prefix=prefix))
            else:
                for i, v in enumerate(node):
                    walk(f"{prefix}{i}.", v, out)
        else:
            out[prefix[:-1]] = torch.from_numpy(
                np.array(node, dtype=np.float32, copy=True))

    state: Dict[str, torch.Tensor] = {}
    walk("", tree, state)
    if module is not None:
        validate_params_for(module, state,
                            what=f"{type(module).__name__} pytree")
    return state


def save_checkpoint(path: str, state, metadata: Optional[Dict] = None
                    ) -> None:
    """Save a training state (model parameters, Adam state and step) to
    `path + ".pt"` with torch.save, and `metadata` to the same
    `path + ".meta.json"` sidecar the JAX package writes.  Both files are
    written to a temporary name and renamed, so a run killed mid-write
    leaves the previous checkpoint whole."""
    path = os.path.abspath(path)
    blob = {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step)}
    tmp = f"{path}.pt.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path + ".pt")
    if metadata:
        tmp = f"{path}.meta.json.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(metadata, f)
        os.replace(tmp, path + ".meta.json")


def load_checkpoint(path: str, state):
    """Restore a save_checkpoint file into `state` (its model and
    optimizer, whose state carries the step) in place and return it.  A
    checkpoint of another model configuration raises ValueError naming
    the mismatched parameters."""
    path = os.path.abspath(path)
    # read on the CPU: load_state_dict copies the parameters and Adam's
    # moments to their devices and keeps Adam's step count on the host
    blob = torch.load(path + ".pt", map_location="cpu", weights_only=True)
    validate_params_for(state.model, blob["model"], what=f"checkpoint {path}")
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    return state


def load_metadata(path: str) -> Optional[Dict]:
    """The `.meta.json` sidecar of a checkpoint, or None."""
    p = os.path.abspath(path) + ".meta.json"
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pt`/`.pth` state_dict file, read with
    weights_only=True (no arbitrary unpickling)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, Mapping):
        raise ValueError(f"{path} does not hold a state_dict")
    return dict(state)


def save_state_dict_file(path: str,
                         state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write a state_dict as a reference-loadable `.pt` file: float32 CPU
    tensors under the module's own keys (the reference's, for VAEHMM), the
    file the JAX package's utils/torch_interop.save_torch_file writes."""
    torch.save({k: v.detach().to("cpu", torch.float32).clone()
                for k, v in state_dict.items()}, path)


# the reference's head layers: RegimePortfolioOptimizer's nn.Sequential
# net.{0,2,4} (the port's own keys), and ImprovedPortfolioOptimizer's K
# per-regime nn.Sequential regime_nets.{r}.{0,3,6}, stacked by the port
_IMPROVED_REF_LAYERS = {"0": "fc1", "3": "fc2", "6": "fc3"}
_REGIME_HEAD_KEYS = {f"net.{i}.{p}" for i in ("0", "2", "4")
                     for p in ("weight", "bias")}


def _check_head_keys(state: Mapping, expected) -> None:
    missing = sorted(expected - set(state))
    extra = sorted(set(state) - expected)
    if missing or extra:
        raise KeyError(f"head state_dict: missing keys {missing}, "
                       f"unrecognised keys {extra}")


def head_state_from_state_dict(state: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """A reference portfolio-head state_dict -> a float32 state_dict for
    the port's head of that family, told apart by the naming:
    `net.{0,2,4}` is RegimePortfolioOptimizer (whose keys the port keeps;
    its fc1 weight is 2-D), `regime_nets.{r}.{0,3,6}` is
    ImprovedPortfolioOptimizer (the K per-regime layers stacked on a
    leading axis as fc{1,2,3}: a 3-D fc1 weight)."""
    if any(k.startswith("regime_nets.") for k in state):
        regimes = sorted({int(k.split(".")[1]) for k in state
                          if k.startswith("regime_nets.")})
        if regimes != list(range(len(regimes))):
            raise KeyError(f"malformed regime_nets indices: {regimes}")
        _check_head_keys(state, {
            f"regime_nets.{r}.{i}.{p}" for r in regimes
            for i in _IMPROVED_REF_LAYERS for p in ("weight", "bias")})
        return {f"{fc}.{p}": torch.stack(
                    [torch.as_tensor(state[f"regime_nets.{r}.{i}.{p}"],
                                     dtype=torch.float32) for r in regimes])
                for i, fc in _IMPROVED_REF_LAYERS.items()
                for p in ("weight", "bias")}
    if any(k.startswith("net.") for k in state):
        _check_head_keys(state, _REGIME_HEAD_KEYS)
        return {k: torch.as_tensor(state[k], dtype=torch.float32)
                for k in sorted(_REGIME_HEAD_KEYS)}
    raise KeyError("state_dict matches no known portfolio head family "
                   f"(keys: {sorted(state)[:6]}...)")


def load_head_file(path: str, K: Optional[int] = None, device="cuda"):
    """A reference `.pt` portfolio head (models/portfolio.pt or
    portfolio_improved.pt) as the port's head module in eval() mode on
    `device`: the family from the state_dict's naming, the widths from its
    weights.  A head whose K differs from `K` raises ValueError."""
    from ..core.device import resolve_device
    from ..models.portfolio import (HeadConfig, ImprovedPortfolioOptimizer,
                                    RegimePortfolioOptimizer)

    state = head_state_from_state_dict(load_state_dict_file(path))
    if "fc1.weight" in state:           # the stacked (K, out, in) bank
        K_head, hidden, _ = state["fc1.weight"].shape
        cfg = HeadConfig(K=K_head, hidden_dim=hidden,
                         n_assets=state["fc3.weight"].shape[1])
        cls = ImprovedPortfolioOptimizer
    else:
        hidden, K_head = state["net.0.weight"].shape
        cfg = HeadConfig(K=K_head, hidden_dim=hidden,
                         n_assets=state["net.4.weight"].shape[0])
        cls = RegimePortfolioOptimizer
    if K is not None and cfg.K != K:
        raise ValueError(f"head checkpoint {path!r} has K={cfg.K} but the "
                         f"model serves K={K}")
    head = cls(cfg, device=resolve_device(device))
    validate_params_for(head, state, what=f"head checkpoint {path!r}")
    head.load_state_dict(state)
    return head.eval()


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
