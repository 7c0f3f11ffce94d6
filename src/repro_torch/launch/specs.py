"""Shape-and-dtype stand-ins for every (arch x shape) cell, on torch's
"meta" device: no storage is allocated (the port of the JAX package's
`launch/specs.py`, whose stand-ins are `jax.ShapeDtypeStruct`s).

Shapes and dtypes equal the JAX package's: int32 tokens, bf16 image
embeddings, and the parameter and cache trees `models.init` and
`models.init_cache` build, built on "meta".
"""
from __future__ import annotations

import torch

from ..configs.base import LONG_500K, ModelConfig, RunConfig, ShapeConfig
from ..models import init as model_init
from ..models import init_cache


def sds(shape, dtype) -> torch.Tensor:
    """An empty meta tensor: the shape and dtype of an input, no data."""
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _tokens(cfg: ModelConfig, b: int, l: int) -> torch.Tensor:
    if cfg.family == "audio":
        return sds((b, l, cfg.audio.n_codebooks), torch.int32)
    return sds((b, l), torch.int32)


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, l = shape.global_batch, shape.seq_len
    tok = _tokens(cfg, b, l)
    specs = {"tokens": tok, "targets": sds(tok.shape, tok.dtype)}
    if cfg.family == "vlm":
        specs["image_embeds"] = sds(
            (b, cfg.vision.n_image_tokens, cfg.d_model), torch.bfloat16)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b, l = shape.global_batch, shape.seq_len
    specs = {"tokens": _tokens(cfg, b, l)}
    if cfg.family == "vlm":
        specs["image_embeds"] = sds(
            (b, cfg.vision.n_image_tokens, cfg.d_model), torch.bfloat16)
    return specs


def decode_input_specs(cfg: ModelConfig, rc: RunConfig,
                       shape: ShapeConfig) -> dict:
    """Token + KV-cache stand-ins for one serve step (cache depth =
    shape.seq_len, one new token)."""
    b = shape.global_batch
    nimg = cfg.vision.n_image_tokens if cfg.family == "vlm" else 0
    cache = init_cache(cfg, rc, b, shape.seq_len, device="meta",
                       n_image_tokens=nimg)
    return {"cache": cache, "tokens": _tokens(cfg, b, 1),
            "pos": sds((), torch.int32)}


def param_shapes(cfg: ModelConfig):
    """The parameter tree of `cfg` on "meta" (no storage; a CPU generator
    is accepted there, and no number is drawn)."""
    return model_init(torch.Generator(), cfg, device="meta")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic attention (assignment note)."""
    if shape.name == LONG_500K.name:
        return cfg.sub_quadratic
    return True
