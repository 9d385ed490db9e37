"""Abstract inputs (``meta`` tensors) and logical dim names for a step.

``step_and_inputs`` builds the step function, its abstract arguments
and their logical dim names for one (model, shape) cell (train,
prefill or decode); ``state_logical_axes`` names a train state's leaves;
``cache_logical_axes`` names every decode-cache leaf;
``specs_from_rules`` turns ``{logical name -> mesh axes}`` rules into a
``PartitionSpec`` per leaf, dropping axes that do not divide a dim.
Nothing here allocates device memory.
"""

from __future__ import annotations

import torch

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.partitioner import (PartitionSpec,
                                          flatten_logical_axes)
from repro_torch.models import transformer as T
from repro_torch.optim.adam import AdamState
from repro_torch.train.steps import (TrainState, make_decode_step,
                                     make_prefill_step, make_train_step,
                                     train_state_specs)


def meta(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: shape and dtype only, nothing allocated."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """The abstract train / prefill batch and its logical dim names.

    Args:
        cfg: the model configuration.
        shape: the cell's shape; ``global_batch`` x ``seq_len`` positions.

    Returns:
        ``(specs, names)``: ``{"tokens": meta (B, S) int32}`` and
        ``{"tokens": ("batch", "seq")}``; an encoder-decoder model
        splits the positions in halves, ``"frames"`` (B, S/2, D) float32
        for the encoder and (B, S/2) tokens; a vision model's
        ``"patch_embeds"`` (B, P, D) float32 take the first P and the
        tokens the rest; ``"targets"`` like the tokens for the train
        kind.
    """
    B, S = shape.global_batch, shape.seq_len
    specs, names = {}, {}
    if cfg.is_encoder_decoder:
        S_enc, S = S // 2, S // 2
        specs["frames"] = meta((B, S_enc, cfg.d_model), torch.float32)
        names["frames"] = ("batch", "seq", "embed")
    elif cfg.frontend == "vision":
        P = cfg.num_patches
        specs["patch_embeds"] = meta((B, P, cfg.d_model), torch.float32)
        names["patch_embeds"] = ("batch", None, "embed")
        S = S - P
    specs["tokens"] = meta((B, S), torch.int32)
    names["tokens"] = ("batch", "seq")
    if shape.kind == "train":
        specs["targets"] = meta((B, S), torch.int32)
        names["targets"] = names["tokens"]
    return specs, names


_CACHE_NAMES = {
    "k": (None, "batch", "seq", "kv_heads", None),
    "v": (None, "batch", "seq", "kv_heads", None),
    "slot_pos": (None, None),
    "h": (None, "batch", "rnn"),
    "conv": (None, "batch", None, "rnn"),
    "C": (None, "batch", "heads", None, None),
    "n": (None, "batch", "heads", None),
    "m": (None, "batch", "heads"),
    "c": (None, "batch", "heads", None),
}


def cache_logical_axes(cache):
    """Logical dim names of every cache leaf, by its key; an unstacked
    tail-layer leaf drops the leading (layer) name."""
    def names(keys, leaf):
        base = _CACHE_NAMES.get(keys[-1])
        if base is None:
            return (None,) * leaf.ndim
        if len(base) > leaf.ndim:
            return base[len(base) - leaf.ndim:]
        return base + (None,) * (leaf.ndim - len(base))
    return pytree.tree_map_with_path(names, cache)


def state_logical_axes(cfg: ModelConfig, state: TrainState) -> TrainState:
    """Logical dim names of a train state: the parameters' names for the
    parameters and both moments, none for the step."""
    pax = T.param_logical_axes(cfg, state.params)
    return TrainState(params=pax, opt=AdamState(step=None, m=pax, v=pax))


def step_and_inputs(cfg: ModelConfig, shape: ShapeConfig):
    """The step of a cell, its abstract arguments and their names.

    - train: ``fn(state, batch) -> (state, metrics)`` with the default
      ``AdamConfig`` and one microbatch;
    - prefill: ``fn(params, batch) -> last-token logits``;
    - decode: ``fn(params, cache, token, pos) -> (logits, cache)``, one
      new token against a ``seq_len``-deep cache; an encoder-decoder
      model's takes a fifth input, ``enc_out`` of (B, min(1500,
      seq_len // 2), D) float32, the encoder's output.

    Args:
        cfg: the model configuration.
        shape: the cell's shape (``kind`` "train", "prefill" or
            "decode").

    Returns:
        ``(fn, args, names)``: ``args`` a tuple of ``meta`` tensor
        trees, ``names`` the same trees with logical dim names.
    """
    if shape.kind == "train":
        state = train_state_specs(cfg)
        bspecs, bnames = batch_specs(cfg, shape)
        return make_train_step(cfg), (state, bspecs), \
            (state_logical_axes(cfg, state), bnames)
    params = T.param_specs(cfg)
    pnames = T.param_logical_axes(cfg, params)
    if shape.kind == "prefill":
        bspecs, bnames = batch_specs(cfg, shape)
        return make_prefill_step(cfg), (params, bspecs), (pnames, bnames)
    if shape.kind != "decode":
        raise ValueError(f"unknown step kind {shape.kind!r}")
    B, S = shape.global_batch, shape.seq_len
    cache = T.init_cache(cfg, B, S, device="meta")
    cnames = cache_logical_axes(cache)
    token = meta((B, 1), torch.int32)
    pos = meta((), torch.int32)
    if cfg.is_encoder_decoder:
        enc = meta((B, min(1500, S // 2), cfg.d_model), torch.float32)
        return make_decode_step(cfg), (params, cache, token, pos, enc), \
            (pnames, cnames, ("batch", None), None,
             ("batch", "seq", "embed"))
    return make_decode_step(cfg), (params, cache, token, pos), \
        (pnames, cnames, ("batch", None), None)


def specs_from_rules(tree, names_tree, rules: dict[str, tuple[str, ...]],
                     axis_sizes: dict[str, int]):
    """``PartitionSpec`` of every leaf from logical-name rules.

    Args:
        tree: a tree of tensors (``meta`` ones suffice).
        names_tree: the same tree with logical-name tuples (or ``None``)
            at the leaves.
        rules: logical name -> mesh axes.
        axis_sizes: mesh axis -> its size.

    Returns:
        The tree of specs; an axis that is of size 1, already used in
        the spec, or does not divide what is left of the dim is dropped.
    """
    leaves = pytree.tree_leaves(tree)
    name_leaves = flatten_logical_axes(names_tree)
    if len(name_leaves) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(name_leaves)} "
                         f"name entries")

    def one(leaf, names):
        if names is None:
            names = (None,) * leaf.ndim
        entries = []
        used: set[str] = set()
        for size, name in zip(leaf.shape, names):
            axes = rules.get(name, ()) if name else ()
            keep = []
            for a in axes:
                f = axis_sizes.get(a, 1)
                if a in used or f <= 1 or size % f != 0:
                    continue
                keep.append(a)
                used.add(a)
                size //= f
            entries.append(keep[0] if len(keep) == 1 else
                           tuple(keep) if keep else None)
        return PartitionSpec(*entries)

    return pytree.unflatten(tree, [one(x, n) for x, n in
                                   zip(leaves, name_leaves)])


def shardings_from_rules(tree, names_tree, rules: dict[str, tuple[str, ...]],
                         mesh):
    """A :class:`~repro_torch.launch.mesh.NamedSharding` for every leaf of
    ``tree`` on ``mesh``: the spec :func:`specs_from_rules` gives it, the
    axis sizes the mesh's.

    Returns:
        ``tree`` with a ``NamedSharding`` at each leaf (a leaf to
        ``pytree``, unlike a ``PartitionSpec``, which is a tuple).
    """
    from repro_torch.launch.mesh import NamedSharding
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return pytree.unflatten(tree, [
        NamedSharding(mesh, specs_from_rules(x, names, rules, sizes))
        for x, names in zip(pytree.tree_leaves(tree),
                            flatten_logical_axes(names_tree))])
