"""The port's dense LM archs (llama3.2-1b, phi3-mini-3.8b, llama3-405b at
their ``reduced()`` widths) against ``repro.models.lm`` on the CPU: the
same numpy tokens into both, the port's parameters loaded from JAX's init
tree. Logits, ``lm_loss``, every gradient, one AdamW step with
microbatches 1 and 2, prefill (last-position logits and the KV cache) and
two decode steps, in float32 at 1e-5 and in the default bfloat16 at 2e-2
(``_lm_parity.assert_close``). llama3-405b's reduced config takes the
two-level remat (``scan_chunks=2``); the reduced llama has GQA groups of 2;
the sequence (21) is not a multiple of ``attn_chunk`` (16). Also the
building blocks, the ``FULL`` configs, their parameter counts and the
``meta`` init's shapes against ``jax.eval_shape`` for all five LM archs.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _lm_parity as H
from repro.configs import registry as jreg
from repro.models.lm import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.models.lm import transformer as ttr

DENSE = ["llama3.2-1b", "phi3-mini-3.8b", "llama3-405b"]
DTYPES = ["float32", "bfloat16"]
# prefill and decode: every arch in float32, llama3.2-1b also in bfloat16
SERVE = [(a, "float32") for a in DENSE] + [("llama3.2-1b", "bfloat16")]
LM_ARCHS = list(jreg.LM_ARCHS)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_logits_and_loss_match_jax(arch, dtype):
    out = H.run(arch, dtype)
    H.assert_close(H.real_vocab(out["logits"], out["vocab"]), dtype, "logits")
    H.assert_close(out["loss"], dtype, "loss")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_gradients_match_jax(arch, dtype):
    out = H.run(arch, dtype)
    for name, pair in out["grads"].items():
        H.assert_close(pair, dtype, name, bf16_rel=H.BF16_GRAD_REL)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_adamw_train_step_matches_jax(arch, dtype, microbatches):
    """One step of ``make_train_step`` (the loss, then AdamW on the
    parameters in their own type: bfloat16 stays bfloat16)."""
    out = H.run(arch, dtype)
    H.assert_close(out[f"step_m{microbatches}_loss"], dtype, "loss")
    for name, pair in out[f"step_m{microbatches}"].items():
        H.assert_close(pair, dtype, name)
    jdt, tdt = out[f"step_m{microbatches}_dtypes"]
    assert jdt == tdt == {dtype}


@pytest.mark.parametrize("arch,dtype", SERVE)
def test_prefill_matches_jax(arch, dtype):
    out = H.run_serve(arch, dtype)
    H.assert_padded_vocab_masked(out["prefill_logits"], out["vocab"])
    H.assert_close(H.real_vocab(out["prefill_logits"], out["vocab"]), dtype,
                   "prefill logits")
    for k, pair in out["prefill_cache"].items():
        H.assert_close(pair, dtype, k)


@pytest.mark.parametrize("arch,dtype", SERVE)
def test_two_decode_steps_match_jax(arch, dtype):
    out = H.run_serve(arch, dtype)
    for i in range(2):
        logits = out[f"decode_{i}_logits"]
        H.assert_padded_vocab_masked(logits, out["vocab"])
        H.assert_close(H.real_vocab(logits, out["vocab"]), dtype,
                       f"decode {i}")
        for k, pair in out[f"decode_{i}_cache"].items():
            H.assert_close(pair, dtype, f"decode {i} cache {k}")


def test_reduced_configs_cover_gqa_padding_and_two_level_remat():
    cfg = treg.get_arch("llama3.2-1b").reduced()
    assert cfg.n_heads // cfg.n_kv_heads == 2
    assert cfg.padded_vocab > cfg.vocab and H.SEQ % cfg.attn_chunk
    cfg = treg.get_arch("llama3-405b").reduced()
    assert cfg.scan_chunks == 2 and cfg.n_units % cfg.scan_chunks == 0


def test_two_level_remat_equals_one_level_to_the_bit():
    """scan_chunks only changes what is recomputed, never the numbers."""
    _, tcfg = H.configs("llama3-405b", "float32")
    tok = torch.from_numpy(H.batch(tcfg.vocab)["tokens"])
    grads = []
    for chunks in (2, None):
        cfg = dataclasses.replace(tcfg, scan_chunks=chunks)
        params = ttr.init_params(cfg, device="cpu", seed=3)
        loss = ttr.lm_loss(cfg, params, {"tokens": tok, "targets": tok})
        grads.append(torch.autograd.grad(loss, list(params.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_rope_matches_jax(positions):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = (np.arange(5) if positions == "1d"
           else rng.integers(0, 100, (2, 5))).astype(np.int32)
    want = jtr._rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = ttr._rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 7, 32)) * 30).astype(np.float32)
    s = rng.normal(size=32).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jtr._rmsnorm(jnp.asarray(x, jdt), jnp.asarray(s, jdt))
        got = ttr._rmsnorm(torch.from_numpy(x).to(tdt),
                           torch.from_numpy(s).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2 if tdt == torch.bfloat16
                                   else 1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,kv_offset", [(True, 0), (True, 7),
                                              (False, 0)])
@pytest.mark.parametrize("sq,chunk", [(21, 16), (16, 16), (5, 16)])
def test_chunked_attention_matches_jax(sq, chunk, causal, kv_offset):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4, sq, 8)).astype(np.float32)
    k = rng.normal(size=(2, 4, sq + kv_offset, 8)).astype(np.float32)
    v = rng.normal(size=(2, 4, sq + kv_offset, 8)).astype(np.float32)
    want = jtr._chunked_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                  chunk=chunk, kv_offset=kv_offset)
    got = ttr._chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, chunk=chunk,
                                 kv_offset=kv_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


#: JAX's LMConfig fields that only its sharded forms read (the row-parallel
#: matmul, flash decode, the shard_map MoE's capacity), at their defaults
#: in every FULL config, the port's too.
SHARDED_ONLY = {"explicit_row_parallel": False, "flash_decode": False,
                "decode_seq_axes": ("model",), "capacity_factor": 1.25}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_config_dims_match_assignment(arch):
    """The port's FULL configs carry JAX's published dimensions, field by
    field, and the same parameter counts."""
    jcfg, tcfg = jreg.get_arch(arch).FULL, treg.get_arch(arch).FULL
    dtypes = ("dtype", "param_dtype", "opt_dtype", "grad_accum_dtype")
    jf, tf = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    for k, default in SHARDED_ONLY.items():
        assert jf[k] == tf[k] == default, k
    assert {k: v for k, v in jf.items() if k not in dtypes} == \
        {k: v for k, v in tf.items() if k not in dtypes and k in jf}
    # the port's own fields (not in JAX's LMConfig) at their defaults
    defaults = {f.name: f.default for f in dataclasses.fields(tcfg)}
    assert {k: v for k, v in tf.items() if k not in jf} == \
        {k: defaults[k] for k in tf if k not in jf}
    for k in dtypes:
        assert str(jf[k].dtype if hasattr(jf[k], "dtype") else jf[k]
                   ).split(".")[-1] in str(tf[k])
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.padded_vocab, tcfg.n_units, tcfg.layers_per_unit) == \
        (jcfg.padded_vocab, jcfg.n_units, jcfg.layers_per_unit)
    for make in (lambda m: m.FULL, lambda m: m.reduced()):
        assert dataclasses.asdict(make(treg.get_arch(arch)))["name"] == \
            dataclasses.asdict(make(jreg.get_arch(arch)))["name"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_meta_init_shapes_match_jax_eval_shape(arch):
    """``init_params(device="meta")`` at FULL width: every leaf's path,
    shape and type as ``jax.eval_shape(init_params)``; nothing allocated."""
    jcfg, tcfg = jreg.get_arch(arch).FULL, treg.get_arch(arch).FULL
    want = H.named_leaves(jax.eval_shape(
        lambda: jtr.init_params(jcfg, jax.random.PRNGKey(0))))
    params = ttr.init_params(tcfg, device="meta")
    got = {n: p for n, p in params.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert p.is_meta
        assert tuple(p.shape) == tuple(want[name].shape), name
        assert str(p.dtype).split(".")[-1] == str(want[name].dtype), name
    n = sum(p.numel() for p in params.parameters())
    padding = 2 * (tcfg.padded_vocab - tcfg.vocab) * tcfg.d_model
    assert n == tcfg.param_count() + padding
