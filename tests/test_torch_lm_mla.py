"""Moonlight-16B-A3B's parts of the port's LM (``models/lm/transformer.py``)
at the tiny form, on the CPU: MLA attention against a float64 oracle
written as modeling_deepseek writes it (rope on de-interleaved pairs by
``rotate_half``), the sigmoid router's choice and weights, the dispatched
MoE against the dense oracle fed the same routing (softmax and sigmoid
routers), the grouped GEMM's plain form against a dense product and its
tile map's rows, ``FULL``'s published sizes, the existing LMs against JAX
(with the dispatched MoE too), and the forms that raise for MLA and the
sigmoid router. The whole scoring cell against the benchmark's plain
reference is ``portbench/test_portbench_moonlight.py``."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import _lm_parity as H
from repro.models import lm as jlm
from repro_torch.configs import moonlight_16b as moon
from repro_torch.kernels import grouped_mm as gmm
from repro_torch.models.lm import transformer as tf

SEED = 7


def _cfg(**kw):
    return dataclasses.replace(moon.reduced(), **kw)


def _params(cfg, seed=SEED):
    """Seeded float64-drawn weights (norms about 1, a decisive router and
    a choice bias of about the scores' gaps) in ``cfg.param_dtype``."""
    p = tf.init_params(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in p.named_parameters():
            scale = {"router_bias": 0.05}.get(name.split(".")[-1], 0.3)
            base = 1.0 if name.split(".")[-1] in ("ln1", "ln2", "ln_f",
                                                   "kv_norm") else 0.0
            t.copy_(base + scale * torch.randn(t.shape, generator=g,
                                               dtype=torch.float64))
    return p.requires_grad_(False)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def _rotate_half(x):
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def _deepseek_rope(x, theta):
    """modeling_deepseek's ``apply_rotary_pos_emb`` on (B, H, S, d): the
    pairs de-interleaved, then ``x * cos + rotate_half(x) * sin`` with
    ``emb = cat(freqs, freqs)``."""
    b, h, s, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
    freqs = torch.outer(torch.arange(s, dtype=torch.float64), inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * emb.cos() + _rotate_half(x) * emb.sin()


def _oracle_mla(cfg, lp, h):
    """DeepseekV3Attention's forward without a q LoRA, in float64."""
    lp = {k: v.double() for k, v in lp.items()}
    h = h.double()
    B, S, _ = h.shape
    H_, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, rank, eps = cfg.v_head_dim, cfg.kv_lora_rank, cfg.norm_eps

    def norm(x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w

    x = norm(h, lp["ln1"])
    q = (x @ lp["wq"]).view(B, S, H_, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], -1)
    ckv = x @ lp["wkv_a"]
    ckv, k_pe = ckv.split([rank, rope], -1)
    k_pe = k_pe.view(B, S, 1, rope).transpose(1, 2)
    kv = (norm(ckv, lp["kv_norm"]) @ lp["wkv_b"]).view(
        B, S, H_, nope + vd).transpose(1, 2)
    k_nope, v = kv.split([nope, vd], -1)
    q_pe = _deepseek_rope(q_pe, cfg.rope_theta)
    k_pe = _deepseek_rope(k_pe, cfg.rope_theta)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(B, H_, S, rope)], -1)
    s = (q @ k.transpose(2, 3)) * (nope + rope) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
    out = (p @ v).transpose(1, 2).reshape(B, S, H_ * vd)
    return h + out @ lp["wo"]


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mla_attention_matches_modeling_deepseek(chunk):
    cfg = _cfg(attn_chunk=chunk, param_dtype=torch.float32)
    lp = {k: v[0] for k, v in _params(cfg).moe.items()}
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    got = tf._mla_attention_block(cfg, lp, h, torch.arange(16))
    want = _oracle_mla(cfg, lp, h)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_rope_pairs_keep_the_scores_of_pairwise_rotation():
    """Rotating the interleaved pairs in place, and de-interleaving then
    rotating halves (the port, modeling_deepseek), give the same q.k;
    rotating halves of the interleaved vector does not."""
    g = torch.Generator().manual_seed(3)
    q, k = (torch.randn(1, 9, 1, 8, generator=g, dtype=torch.float64)
            for _ in range(2))
    pos = torch.arange(9)

    def pairwise(x):
        d = x.shape[-1]
        ang = pos.double()[:, None] * 50_000.0 ** (
            -torch.arange(0, d, 2, dtype=torch.float64) / d)
        cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
        a, b = x[..., 0::2], x[..., 1::2]
        return torch.stack([a * cos - b * sin, b * cos + a * sin],
                           -1).flatten(-2)

    def scores(rope):
        return torch.einsum("bqhd,bkhd->qk", rope(q), rope(k))

    want = scores(pairwise)
    got = scores(lambda x: tf._rope_pairs(x, pos, 50_000.0))
    halves = scores(lambda x: tf._rope(x, pos, 50_000.0))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert (halves - want).abs().max() > 0.1


# --------------------------------------------------------------------------
# The sigmoid router
# --------------------------------------------------------------------------

def test_sigmoid_router_chooses_by_score_plus_bias_weighs_by_score():
    cfg = _cfg(n_experts=4, top_k=2, d_model=4)
    logits = torch.tensor([[2.0, 1.9, 0.0, -1.0],
                           [0.0, 0.1, 0.2, 3.0]])
    bias = torch.tensor([0.0, 0.0, 0.5, 0.0])
    lp = {"router": torch.eye(4), "router_bias": bias}
    top_p, top_i = tf._route(cfg, lp, logits)
    s = torch.sigmoid(logits)
    # row 0: the bias lifts expert 2 (0.5 + 0.5) over expert 1 (0.87)
    assert sorted(top_i[0].tolist()) == [0, 2]
    assert sorted(top_i[1].tolist()) == [2, 3]
    for r, chosen in enumerate(top_i.tolist()):
        w = s[r, chosen] / s[r, chosen].sum() * 2.446
        np.testing.assert_allclose(top_p[r].numpy(), w.numpy(), rtol=1e-6)
    assert abs(float(top_p.sum(-1)[0]) - 2.446) < 1e-5


def test_softmax_router_is_unchanged():
    cfg = _cfg(router="softmax")
    g = torch.Generator().manual_seed(2)
    xt, w = torch.randn(10, 64, generator=g), torch.randn(64, 8, generator=g)
    probs = torch.softmax(xt @ w, -1)
    want_p, want_i = torch.topk(probs, 2, -1)
    got_p, got_i = tf._route(cfg, {"router": w}, xt)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_p, want_p / want_p.sum(-1, keepdim=True))


# --------------------------------------------------------------------------
# The dispatched MoE
# --------------------------------------------------------------------------

@pytest.mark.parametrize("router", ["sigmoid", "softmax"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatched_moe_matches_the_dense_oracle(router, dtype):
    cfg = _cfg(router=router, dtype=dtype)
    lp = {k: v[1] for k, v in _params(cfg).moe.items()}
    h = torch.randn(3, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4)).to(dtype)
    xt = tf._rmsnorm(h, lp["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
    routing = tf._route(cfg, lp, xt)
    assert len(set(routing[1].reshape(-1).tolist())) == cfg.n_experts

    def fed(cfg_, lp_, xt_):
        assert torch.equal(xt_, xt)
        return routing

    got = tf._moe_ffn_dispatched(cfg, lp, h, fed)
    want = tf._moe_ffn_dense(cfg, lp, h, fed)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


def test_dispatched_moe_counts_slots_and_grouped_products(monkeypatch):
    """Each MoE layer makes three grouped products (gate, up, down), each
    over every routed slot, T x top_k rows, split by the experts' ends."""
    from repro_torch.obs import Recorder, get_recorder, set_recorder

    made = []
    real = gmm.grouped_mm

    def counted(a, b, ends):
        made.append((a.shape[0], int(ends[-1]), tuple(b.shape)))
        return real(a, b, ends)

    monkeypatch.setattr(gmm, "grouped_mm", counted)
    cfg = _cfg()
    p = _params(cfg)
    before = get_recorder()
    rec = set_recorder(Recorder())
    try:
        tf.forward(cfg, p, torch.randint(0, 256, (2, 16)))
    finally:
        set_recorder(before)
    slots = 2 * 16 * cfg.top_k
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff_moe
    assert made == [(slots, slots, (E, D, F_)), (slots, slots, (E, D, F_)),
                    (slots, slots, (E, F_, D))] * 2
    names = [s.name for s in rec.tracer.spans]
    assert names.count("lm.attention") == 3 and names.count("lm.moe") == 2


def test_dispatched_path_never_calls_the_dense_oracle(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the dense oracle ran")

    monkeypatch.setattr(tf, "_moe_ffn_dense", refuse)
    cfg = _cfg()
    out = tf.forward(cfg, _params(cfg), torch.randint(0, 256, (1, 16)))
    assert torch.isfinite(out).all()


# --------------------------------------------------------------------------
# The grouped GEMM's plain form
# --------------------------------------------------------------------------

@pytest.mark.parametrize("counts", [[7, 0, 130, 1, 12], [0, 0, 0, 0, 256],
                                    [1, 1, 1, 1, 1], [3, 0, 0, 0, 2]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_mm_plain_matches_a_dense_product(counts, dtype):
    g = torch.Generator().manual_seed(5)
    E, K, N = 5, 24, 40
    counts = torch.tensor(counts)
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    a = torch.randn(int(counts.sum()), K, generator=g).to(dtype)
    b = torch.randn(E, K, N, generator=g).to(dtype)
    got = gmm.grouped_mm(a, b, ends)
    expert = torch.repeat_interleave(torch.arange(E), counts)
    want = torch.einsum("mk,mkn->mn", a.double(), b[expert].double())
    np.testing.assert_allclose(got.double().numpy(),
                               want.to(dtype).double().numpy(),
                               rtol=1e-2 if dtype == torch.bfloat16
                               else 1e-5, atol=1e-4)


def test_grouped_mm_refuses_what_the_kernel_does_not_take():
    a, b = torch.zeros(4, 8), torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="one end an expert"):
        gmm.grouped_mm(a, b, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match=r"a \(M, K\) and b \(E, K, N\)"):
        gmm.grouped_mm(a, torch.zeros(2, 7, 3),
                       torch.tensor([1, 4], dtype=torch.int32))


# --------------------------------------------------------------------------
# FULL, the existing LMs, and what raises
# --------------------------------------------------------------------------

def test_full_is_the_published_config():
    c = moon.FULL
    assert (c.n_layers, c.d_model, c.n_heads, c.vocab, c.rope_theta) == \
        (27, 2048, 16, 163840, 50_000.0)
    assert (c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim,
            c.v_head_dim) == (512, 128, 64, 128)
    assert (c.first_k_dense, c.d_ff, c.n_experts, c.d_ff_moe, c.top_k,
            c.n_shared_experts) == (1, 11264, 64, 1408, 6, 2)
    assert (c.router, c.routed_scaling_factor, c.norm_eps, c.moe_impl) == \
        ("sigmoid", 2.446, 1e-5, "dispatched")
    assert c.param_count() == 15_960_110_208
    model = moon.make_model(device="meta")
    assert sum(p.numel() for p in model.parameters()) == c.param_count()
    assert model.moe["router_bias"].dtype == torch.float32
    assert model.moe["we_gate"].shape == (26, 64, 2048, 1408)
    assert model.dense["w_gate"].shape == (1, 2048, 11264)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi3-mini-3.8b",
                                  "granite-moe-1b-a400m"])
def test_existing_lms_are_unchanged(arch):
    """The reduced LMs' float32 logits against JAX's, as before the port's
    own fields; granite's also through the dispatched MoE."""
    jcfg, tcfg = H.configs(arch, "float32")
    jp, tp = H.params_pair(jcfg, tcfg)
    tokens = H.batch(tcfg.vocab)["tokens"]
    want = np.asarray(jax.jit(lambda p, t: jlm.forward(jcfg, p, t))(
        jp, jnp.asarray(tokens)))
    forms = [tcfg] + ([dataclasses.replace(tcfg, moe_impl="dispatched")]
                      if tcfg.moe else [])
    for cfg in forms:
        with torch.no_grad():
            got = tf.forward(cfg, tp, torch.from_numpy(tokens))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mesh_cache_prefill_and_decode_raise_for_mla_and_sigmoid():
    from repro_torch.models.lm import sharded

    for cfg in (_cfg(), _cfg(router="softmax", first_k_dense=0),
                _cfg(attention="gqa", head_dim=16, first_k_dense=0)):
        for make in (lambda: tf.init_cache(cfg, 1, 8, device="cpu"),
                     lambda: tf.make_prefill_step(cfg),
                     lambda: tf.make_decode_step(cfg),
                     lambda: sharded.param_specs(cfg, None),
                     lambda: sharded.cache_specs(cfg, None)):
            with pytest.raises(NotImplementedError, match="not written"):
                make()
    with pytest.raises(NotImplementedError, match="scoring only"):
        tf.make_train_step(_cfg())
