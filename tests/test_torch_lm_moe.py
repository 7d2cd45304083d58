"""The port's MoE LM archs (granite-moe-1b-a400m: 8 experts, top-2, every
layer; llama4-maverick: 8 experts, top-1, interleaved every 2nd layer with
a shared expert; both at their ``reduced()`` widths) against
``repro.models.lm`` on the CPU, through ``_moe_ffn_dense``, the path JAX
runs without a mesh.

float32, at 1e-5: logits, ``lm_loss``, every gradient, one AdamW step with
microbatches 1 and 2, prefill and two decode steps. bfloat16: a token whose
router scores lie within rounding of a tie takes another expert in each
package (the float32 runs route alike), and from that token on its causal
logits and the gradients of every layer differ; so the bfloat16 cases hold
the loss and the AdamW step at 2e-2, and pin how many rows of logits the
flips move past 2e-2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _lm_parity as H
from repro.models.lm import transformer as jtr
from repro_torch.configs import registry as treg
from repro_torch.models.lm import transformer as ttr

MOE = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]
#: bfloat16 logit rows (of 84) past 2e-2 relative, measured: the routing
#: flips above.
BF16_ROWS_APART = {"granite-moe-1b-a400m": 3, "llama4-maverick-400b-a17b": 33}


@pytest.mark.parametrize("arch", MOE)
def test_logits_and_loss_match_jax(arch):
    out = H.run(arch, "float32")
    H.assert_close(H.real_vocab(out["logits"], out["vocab"]), "float32")
    H.assert_close(out["loss"], "float32")


@pytest.mark.parametrize("arch", MOE)
def test_gradients_match_jax(arch):
    out = H.run(arch, "float32")
    for name, pair in out["grads"].items():
        H.assert_close(pair, "float32", name)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_adamw_train_step_matches_jax(arch, dtype, microbatches):
    out = H.run(arch, dtype)
    H.assert_close(out[f"step_m{microbatches}_loss"], dtype, "loss")
    for name, pair in out[f"step_m{microbatches}"].items():
        H.assert_close(pair, dtype, name)
    jdt, tdt = out[f"step_m{microbatches}_dtypes"]
    assert jdt == tdt == {dtype}


@pytest.mark.parametrize("arch", MOE)
def test_bfloat16_loss_matches_and_routing_flips_stay_pinned(arch):
    out = H.run(arch, "bfloat16")
    H.assert_close(out["loss"], "bfloat16", "loss")
    j, t = H.real_vocab(out["logits"], out["vocab"])
    assert np.isfinite(t).all()
    rows = (np.linalg.norm(t - j, axis=-1)
            / np.linalg.norm(j, axis=-1)).ravel()
    assert rows.size == H.BATCH * H.SEQ
    assert int((rows > H.TOLS["bfloat16"]).sum()) <= BF16_ROWS_APART[arch]


@pytest.mark.parametrize("arch", MOE)
def test_prefill_matches_jax(arch):
    out = H.run_serve(arch, "float32")
    H.assert_padded_vocab_masked(out["prefill_logits"], out["vocab"])
    H.assert_close(H.real_vocab(out["prefill_logits"], out["vocab"]),
                   "float32", "prefill logits")
    for k, pair in out["prefill_cache"].items():
        H.assert_close(pair, "float32", k)


@pytest.mark.parametrize("arch", MOE)
def test_two_decode_steps_match_jax(arch):
    out = H.run_serve(arch, "float32")
    for i in range(2):
        logits = out[f"decode_{i}_logits"]
        H.assert_padded_vocab_masked(logits, out["vocab"])
        H.assert_close(H.real_vocab(logits, out["vocab"]), "float32",
                       f"decode {i}")
        for k, pair in out[f"decode_{i}_cache"].items():
            H.assert_close(pair, "float32", f"decode {i} cache {k}")


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_dense_matches_jax_with_its_gradients(arch):
    """One MoE sublayer on continuous inputs (no router ties): the routed
    experts, the one-hot combine and Maverick's shared expert, and the
    gradients of the input and of every expert weight."""
    import jax

    jcfg, tcfg = H.configs(arch, "float32")
    jp, tp = H.params_pair(jcfg, tcfg)
    jlp = {k: v[0] for k, v in jp["moe"].items()}
    tlp = {k: v[0] for k, v in tp.moe.items()}
    h = np.random.default_rng(4).normal(
        size=(2, 9, jcfg.d_model)).astype(np.float32)

    def jloss(lp, x):
        return jnp.sum(jnp.sin(jtr._moe_ffn_dense(jcfg, lp, x)))

    jy = jtr._moe_ffn_dense(jcfg, jlp, jnp.asarray(h))
    jg_lp, jg_h = jax.grad(jloss, argnums=(0, 1))(jlp, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tlp.items()}
    ty = ttr._moe_ffn_dense(tcfg, leaves, th)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    names = sorted(leaves)
    grads = torch.autograd.grad(torch.sum(torch.sin(ty)),
                                [th] + [leaves[k] for k in names],
                                allow_unused=True)  # the attention's leaves
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_h),
                               rtol=1e-5, atol=1e-5)
    for k, g in zip(names, grads[1:]):
        want = np.asarray(jg_lp[k])
        if g is None:
            assert not want.any(), k
            continue
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert ("ws_gate" in names) == (arch == "llama4-maverick-400b-a17b")


def test_maverick_units_interleave_dense_then_moe():
    cfg = treg.get_arch("llama4-maverick-400b-a17b").reduced()
    assert ttr._sub_kinds(cfg) == ["dense", "moe"]
    assert (cfg.n_units, cfg.layers_per_unit) == (2, 2)
    params = ttr.init_params(cfg, device="meta")
    assert set(params.stacks()) == {"dense", "moe"}
    assert params.moe["we_gate"].shape == (2, cfg.n_experts, cfg.d_model,
                                           cfg.d_ff_moe)
    assert params.moe["ws_gate"].shape == (2, cfg.d_model, cfg.d_ff_moe)
    cache = ttr.init_cache(cfg, 3, 8, device="meta")
    assert cache["k"].shape == (2, 2, 3, 8, cfg.n_kv_heads, cfg.head_dim)
    granite = treg.get_arch("granite-moe-1b-a400m").reduced()
    assert ttr._sub_kinds(granite) == ["moe"]
