"""The LM-family architectures' shapes, dry-run cells and smoke batch
(port of ``repro.configs.lm_common``), and the port's bulk scoring entry
(:func:`score_bulk`).

Shapes (assigned set):
  train_4k     seq 4096,   global_batch 256  -> train_step (AdamW, microbatched)
  prefill_32k  seq 32768,  global_batch 32   -> prefill (logits + KV cache out)
  decode_32k   seq 32768,  global_batch 128  -> serve_step (1 new token vs cache)
  long_500k    seq 524288, global_batch 1    -> serve_step
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import optim as optim_lib
from repro_torch.configs.common import Cell, dp_axes, dp_size, local_empty
from repro_torch.data.staging import staging_for
from repro_torch.distrib.shardings import P
from repro_torch.models.lm import LMConfig
from repro_torch.models.lm import sharded
from repro_torch.models.lm import transformer as tf

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def _attn_flops(cfg: LMConfig, batch: int, seq: int, causal: bool) -> float:
    per_layer = 4.0 * batch * seq * seq * cfg.n_heads * cfg.head_dim
    if causal:
        per_layer /= 2
    return per_layer * cfg.n_layers


def _params_shapes(cfg: LMConfig):
    """``{name: (global shape, dtype)}`` of the parameters (JAX's
    ``_params_sds``), from a ``meta`` build."""
    return {n: (tuple(p.shape), p.dtype)
            for n, p in tf.init_params(cfg, device="meta").named_parameters()}


def _local_params(cfg: LMConfig, mesh, device) -> tf.LMParams:
    """This rank's blocks of the parameters by ``param_specs`` (fake under
    the caller's ``FakeTensorMode``)."""
    specs = sharded.param_specs(cfg, mesh)
    return sharded._with_params(cfg, {
        name: local_empty(mesh, sharded._spec_of(specs, name), shape, dtype,
                          device)
        for name, (shape, dtype) in _params_shapes(cfg).items()})


def _opt_specs(pspecs):
    return (optim_lib.ScaleByAdamState(count=P(), mu=pspecs, nu=pspecs),
            (), ())


def build_lm_cell(cfg: LMConfig, shape: str, mesh) -> Cell:
    """The cell of ``cfg`` at ``shape`` on ``mesh``: the sharded forms of
    :mod:`repro_torch.models.lm.sharded` over this rank's blocks. Decode
    splits the batch over the data axes where they divide it, else the
    cache's sequence over every axis (JAX's rule)."""
    info = SHAPES[shape]
    B, S = info["batch"], info["seq"]
    dp = dp_axes(mesh)
    device = mesh.device_type
    pspecs = sharded.param_specs(cfg, mesh)
    params = _local_params(cfg, mesh, device)

    if info["kind"] == "train":
        optimizer = optim_lib.adamw(3e-4, moment_dtype=cfg.opt_dtype)
        opt_state = optimizer.init(list(params.parameters()))
        bspecs = {"tokens": P(dp, None), "targets": P(dp, None)}
        batch = {k: local_empty(mesh, bspecs[k], (B, S), torch.int32, device)
                 for k in bspecs}
        return Cell(
            arch=cfg.name, shape=shape, kind="train",
            fn=tf.make_train_step(cfg, optimizer, mesh),
            args=(params, opt_state, batch),
            in_specs=(pspecs, _opt_specs(pspecs), bspecs),
            out_specs=(pspecs, _opt_specs(pspecs), P()),
            model_flops=6.0 * cfg.active_param_count() * B * S
            + 3 * _attn_flops(cfg, B, S, causal=True),
            donate=(0, 1),
            notes=f"microbatches={cfg.microbatches} "
                  f"scan_chunks={cfg.scan_chunks}",
        )

    if info["kind"] == "prefill":
        tokens = local_empty(mesh, P(dp, None), (B, S), torch.int32, device)
        cspecs = sharded.cache_specs(cfg, mesh)
        return Cell(
            arch=cfg.name, shape=shape, kind="prefill",
            fn=tf.make_prefill_step(cfg, mesh),
            args=(params, tokens),
            in_specs=(pspecs, P(dp, None)),
            out_specs=(P(dp, None, "model"), cspecs),
            model_flops=2.0 * cfg.active_param_count() * B * S
            + _attn_flops(cfg, B, S, causal=True),
            notes="emits KV cache + last-position logits only",
        )

    # decode
    batch_shardable = B % dp_size(mesh) == 0
    dec_dp = dp if batch_shardable else ()
    seq_axes = ("model",) if batch_shardable else tuple(mesh.mesh_dim_names)
    cfg = dataclasses.replace(cfg, decode_seq_axes=seq_axes)
    cspec = P(None, None, dec_dp if dec_dp else None, seq_axes, None, None)
    cshape = (cfg.n_units, cfg.layers_per_unit, B, S, cfg.n_kv_heads,
              cfg.head_dim)
    cache = {k: local_empty(mesh, cspec, cshape, cfg.dtype, device)
             for k in ("k", "v")}
    tok_spec = P(dec_dp if dec_dp else None, None)
    tokens = local_empty(mesh, tok_spec, (B, 1), torch.int32, device)
    return Cell(
        arch=cfg.name, shape=shape, kind="decode",
        fn=tf.make_decode_step(cfg, mesh, dp_axes=dec_dp),
        # the new token at the cache's last position
        args=(params, cache, tokens, S - 1),
        in_specs=(pspecs, {"k": cspec, "v": cspec}, tok_spec, P()),
        out_specs=(P(tok_spec[0], None, "model"), {"k": cspec, "v": cspec}),
        model_flops=2.0 * cfg.active_param_count() * B
        + 4.0 * B * S * cfg.n_heads * cfg.head_dim * cfg.n_layers,
        donate=(1,),
        notes=f"KV cache {S} tokens; seq sharded over {seq_axes}",
    )


def lm_smoke_batch(cfg: LMConfig, batch: int = 2, seq: int = 16,
                   gen: Optional[torch.Generator] = None, device="cuda"):
    """Random tokens in [0, vocab), the targets equal to the tokens (JAX's
    smoke batch, drawn from ``gen``, default seeded with 0)."""
    if gen is None:
        gen = torch.Generator(device=torch.device(device)).manual_seed(0)
    tok = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                        device=device, dtype=torch.int32)
    return {"tokens": tok, "targets": tok}


#: Rows of :func:`score_bulk`'s head a block: the float32 logits of a
#: block over a 163,840-token vocabulary are 2.7 GB (those of a whole
#: 8 x 4,096 call would be 21.5 GB).
HEAD_ROWS = 4096


@torch.no_grad()
def score_bulk(model, tokens: np.ndarray) -> np.ndarray:
    """Bulk scoring: the ``(B, S)`` int32 token batch copied to the model's
    device, the forward over it, and the ``(B, S - 1)`` float32 log P of
    each next token (:func:`~repro_torch.models.lm.transformer.
    next_token_logp`, :data:`HEAD_ROWS` rows a block) copied back. The
    model is an LM's parameters with its ``LMConfig`` on ``lm_config``.

    On a CUDA card the batch goes in, and the answer comes out, through the
    model's pinned staging (:mod:`repro_torch.data.staging`, as
    ``clax_baidu.serve_bulk``); on the CPU the arrays are copied as they
    lie."""
    cfg = model.lm_config
    device = model.embed.device
    staging = staging_for(model, device)
    host = {"tokens": np.ascontiguousarray(tokens, dtype=np.int32)}
    if staging is None:
        batch = torch.from_numpy(host["tokens"]).to(device)
    else:
        batch = staging.copy_in(host, device)[0]["tokens"]
    h = tf.hidden(cfg, model, batch)
    logp = tf.next_token_logp(cfg, model, h, batch, HEAD_ROWS)
    if staging is None:
        return logp.cpu().numpy()
    return staging.copy_out(logp, device)
