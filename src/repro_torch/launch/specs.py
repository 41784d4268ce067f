"""Input, parameter and cache stand-ins with their shardings for every cell
(port of ``repro.launch.specs``).

``input_specs(cfg, shape, shd)`` returns (batch structs, batch shardings)
for the step kind the shape dictates.  A struct is a ``meta`` tensor (shape
and dtype, no storage) and a sharding a ``sharding.NamedSharding`` (the
resolved spec and each device's shard shape): nothing is allocated, as the
dry run requires.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.decode import cache_specs, init_cache
from repro_torch.models.lm import param_specs
from repro_torch.sharding import P, AxisRules

ACT_DTYPE = torch.bfloat16


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _shards(batch, specs, shd: AxisRules):
    return {k: shd.sharding(specs[k], tuple(batch[k].shape)) for k in batch}


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, shd: AxisRules):
    B, S = shape.global_batch, shape.seq_len
    n_micro = cfg.microbatch
    assert B % max(n_micro, 1) == 0
    Bm = B // n_micro

    def lead(*dims):
        return (n_micro,) + dims if n_micro > 1 else dims

    def spec(*axes):
        return P(*((None,) + axes if n_micro > 1 else axes))

    batch = {"tokens": _sds(lead(Bm, S), torch.int32), "labels": _sds(lead(Bm, S), torch.int32)}
    specs = {"tokens": spec("batch", None), "labels": spec("batch", None)}
    if cfg.encoder_decoder:
        batch["frames"] = _sds(lead(Bm, cfg.enc_seq_len, cfg.d_model), ACT_DTYPE)
        specs["frames"] = spec("batch", None, None)
    if cfg.mrope_sections is not None:
        batch["positions"] = _sds(lead(Bm, 3, S), torch.int32)
        specs["positions"] = spec("batch", None, None)
    return batch, _shards(batch, specs, shd)


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec, shd: AxisRules):
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((B, S), torch.int32)}
    specs = {"tokens": P("batch", None)}
    if cfg.encoder_decoder:
        batch["frames"] = _sds((B, cfg.enc_seq_len, cfg.d_model), ACT_DTYPE)
        specs["frames"] = P("batch", None, None)
    if cfg.mrope_sections is not None:
        batch["positions"] = _sds((B, 3, S), torch.int32)
        specs["positions"] = P("batch", None, None)
    return batch, _shards(batch, specs, shd)


def decode_batch_specs(cfg: ArchConfig, shape: ShapeSpec, shd: AxisRules):
    B = shape.global_batch
    batch = {"token": _sds((B,), torch.int32)}
    specs = {"token": P("batch")}
    if cfg.mrope_sections is not None:
        batch["positions"] = _sds((B, 3), torch.int32)
        specs["positions"] = P("batch", None)
    return batch, _shards(batch, specs, shd)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, shd: AxisRules):
    if shape.kind == "train":
        return train_batch_specs(cfg, shape, shd)
    if shape.kind == "prefill":
        return prefill_batch_specs(cfg, shape, shd)
    return decode_batch_specs(cfg, shape, shd)


# ---------------------------------------------------------------------------
# Param / cache abstract trees with shardings
# ---------------------------------------------------------------------------


def param_structs(cfg: ArchConfig, shd: AxisRules, dtype=ACT_DTYPE):
    """(meta tensors, logical specs, shardings or None without a mesh) of
    the parameter tree, in the reference's layout (``lm.param_specs``)."""
    shapes, specs = param_specs(cfg, dtype)
    return shapes, specs, shd.resolve_tree(shapes, specs) if shd.mesh is not None else None


def cache_structs(cfg: ArchConfig, shape: ShapeSpec, shd: AxisRules, dtype=ACT_DTYPE):
    """(meta tensors, logical specs, shardings or None) of the cache of a
    ``shape.global_batch`` x ``shape.seq_len`` cell (``decode.init_cache``;
    ``len`` an int32 scalar, as the reference's)."""
    shapes = dict(init_cache(cfg, shape.global_batch, shape.seq_len, dtype, device="meta"), len=_sds((), torch.int32))
    specs = cache_specs(cfg)
    return shapes, specs, shd.resolve_tree(shapes, specs) if shd.mesh is not None else None
