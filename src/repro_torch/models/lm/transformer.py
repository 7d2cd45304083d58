"""Decoder-only transformer family (llama3 / phi3 / granite-MoE / llama4),
port of ``repro.models.lm.transformer``. This module holds the
single-device forms; with ``mesh=`` every entry point runs the sharded
form of :mod:`repro_torch.models.lm.sharded` (tensor parallelism over
``model``, FSDP over the data axes, the capacity-bounded MoE, flash
decoding) over this rank's shards.

* **stacked layers**: each layer parameter is stored stacked over units,
  ``(U, ...)``, under the JAX tree's paths (``dense.wq``, ``moe.we_gate``,
  ``embed``, ``ln_f``, ``lm_head``). A forward unbinds each stack once,
  outside the checkpointed unit, where JAX scans over it: indexing
  ``stack[u]`` per unit would back up a zero gradient of the whole stack
  for every unit.
* **remat**: each unit is a non-reentrant ``torch.utils.checkpoint``, and
  with ``scan_chunks`` a chunk of checkpointed units is checkpointed again
  (JAX's two-level scan).
* **attention**: the q-block-chunked softmax(QK^T)V in float32 that JAX runs
  (``_chunked_attention``), so the (S, S) scores never materialize; GQA's
  KV heads repeated with ``repeat_interleave``. No JAX code calls the Pallas
  flash kernel, and this port calls no kernel here either. The port's own
  ``attention="mla"`` is DeepSeek's latent attention (``_mla_attention_block``).
* **MoE**: the dense oracle JAX runs without a mesh (every expert over
  every token, a one-hot combine, the shared expert); the port's own
  ``moe_impl="dispatched"`` runs the routed slots alone through grouped
  GEMMs (``_moe_ffn_dispatched``), and ``router="sigmoid"`` is
  DeepSeek-V3's scoring with a float32 choice bias (``_route``).
* **decode**: a KV cache stacked ``(U, sub, B, S, Hkv, Dh)``, written in
  place at the decode index.
* **microbatching**: the train step accumulates gradients over
  ``microbatches`` in ``grad_accum_dtype``, in JAX's order.

The train step updates the parameters in place (one fused ``adamw`` launch
per tensor on the card, over bfloat16 parameters too). ``LMConfig`` begins
with JAX's fields, field by field, the sharded forms' ``capacity_factor``,
``explicit_row_parallel``, ``flash_decode`` and ``decode_seq_axes``
included (the single-device forms read none of the four); the port's own
fields follow (Moonlight-16B-A3B's MLA, sigmoid router, leading dense
layers, norm eps and dispatched MoE), whose defaults are JAX's models.
Those run on a single device, forward only (:func:`single_device_only`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import optim as optim_lib
from repro_torch.nn.module import Module
from repro_torch.obs import get_recorder


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None
    rope_theta: float = 500_000.0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    d_ff_moe: int = 0
    moe_layer_step: int = 1          # 1 = every layer MoE, 2 = alternate
    n_shared_experts: int = 0        # llama4-style always-on shared expert
    capacity_factor: float = 1.25    # the sharded MoE's tokens per expert
    # numerics / memory
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    opt_dtype: Any = torch.float32    # AdamW moments (bf16 for 400B-class)
    remat: bool = True
    attn_chunk: int = 1024            # q-block size for chunked attention
    scan_chunks: Optional[int] = None  # two-level remat factor
    grad_accum_dtype: Any = torch.float32  # microbatch grad accumulator
    explicit_row_parallel: bool = False  # wo / w_down summed in dtype
    flash_decode: bool = False        # partial-softmax decode on a mesh
    decode_seq_axes: Tuple[str, ...] = ("model",)  # KV cache seq sharding
    microbatches: int = 1
    max_seq: int = 8192               # decode cache capacity
    # The port's own fields (JAX's LMConfig has none of them); their
    # defaults are the LMs above, bit for bit.
    attention: str = "gqa"            # "mla": DeepSeek's latent attention
    kv_lora_rank: int = 0             # MLA: the latent's width
    qk_nope_head_dim: int = 0         # MLA: q / k dims without rope
    qk_rope_head_dim: int = 0         # MLA: q / k dims with rope
    v_head_dim: int = 0               # MLA: v's dims a head
    router: str = "softmax"           # "sigmoid": scores + a choice bias
    routed_scaling_factor: float = 1.0  # the chosen weights' scale
    first_k_dense: int = 0            # leading dense layers (own stack)
    norm_eps: float = 1e-6            # every RMSNorm's eps
    moe_impl: str = "dense"           # "dispatched": sorted grouped GEMMs

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.d_model // self.n_heads
        if self.moe and self.d_ff_moe == 0:
            self.d_ff_moe = self.d_ff
        if self.attention not in ("gqa", "mla"):
            raise ValueError(f"no attention {self.attention!r} (gqa, mla)")
        if self.router not in ("softmax", "sigmoid"):
            raise ValueError(f"no router {self.router!r} (softmax, sigmoid)")
        if self.moe_impl not in ("dense", "dispatched"):
            raise ValueError(f"no MoE form {self.moe_impl!r} "
                             "(dense, dispatched)")
        if self.first_k_dense and not (self.moe and self.moe_layer_step == 1):
            raise ValueError("leading dense layers come before a stack of "
                             "MoE layers only (moe, moe_layer_step 1)")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 16; the padded logit columns are
        masked to -inf in the loss and in decode outputs."""
        return -(-self.vocab // 16) * 16

    @property
    def n_units(self) -> int:
        if self.first_k_dense:
            return self.n_layers
        return self.n_layers // self.moe_layer_step if self.moe else self.n_layers

    @property
    def layers_per_unit(self) -> int:
        return self.moe_layer_step if self.moe else 1

    @property
    def n_moe_layers(self) -> int:
        if not self.moe:
            return 0
        return self.n_layers // self.moe_layer_step - self.first_k_dense

    def _attention_params(self) -> int:
        D, Dh = self.d_model, self.head_dim
        if self.attention == "mla":
            rank, rope = self.kv_lora_rank, self.qk_rope_head_dim
            q = self.n_heads * (self.qk_nope_head_dim + rope)
            kv = self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
            return (D * q + D * (rank + rope) + rank + rank * kv
                    + self.n_heads * self.v_head_dim * D)
        return D * self.n_heads * Dh * 2 + D * self.n_kv_heads * Dh * 2

    def param_count(self) -> int:
        D = self.d_model
        attn = self._attention_params()
        dense_ffn = 3 * D * self.d_ff
        total = 2 * self.vocab * D + self.n_layers * (attn + 2 * D) + D
        if not self.moe:
            return total + self.n_layers * dense_ffn
        n_moe = self.n_moe_layers
        n_dense = self.n_layers - n_moe
        total += n_dense * dense_ffn
        total += n_moe * (self.n_experts * 3 * D * self.d_ff_moe + D * self.n_experts)
        total += n_moe * self.n_shared_experts * 3 * D * self.d_ff_moe
        if self.router == "sigmoid":
            total += n_moe * self.n_experts  # the choice bias
        return total

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        D = self.d_model
        n_moe = self.n_moe_layers
        routed = self.n_experts * 3 * D * self.d_ff_moe
        active_routed = self.top_k * 3 * D * self.d_ff_moe
        return self.param_count() - n_moe * (routed - active_routed)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _attention_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    D, Dh, H = cfg.d_model, cfg.head_dim, cfg.n_heads
    if cfg.attention == "mla":
        rank, rope = cfg.kv_lora_rank, cfg.qk_rope_head_dim
        return {"wq": (D, H * (cfg.qk_nope_head_dim + rope)),
                "wkv_a": (D, rank + rope), "kv_norm": (rank,),
                "wkv_b": (rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                "wo": (H * cfg.v_head_dim, D)}
    return {"wq": (D, H * Dh), "wk": (D, cfg.n_kv_heads * Dh),
            "wv": (D, cfg.n_kv_heads * Dh), "wo": (H * Dh, D)}


def _dense_layer_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    D = cfg.d_model
    return {
        "ln1": (D,), "ln2": (D,), **_attention_shapes(cfg),
        "w_gate": (D, cfg.d_ff), "w_up": (D, cfg.d_ff), "w_down": (cfg.d_ff, D),
    }


def _moe_layer_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_ff_moe
    shapes = {"ln1": (D,), "ln2": (D,), **_attention_shapes(cfg),
              "router": (D, E)}
    if cfg.router == "sigmoid":
        shapes["router_bias"] = (E,)
    shapes.update({"we_gate": (E, D, F_), "we_up": (E, D, F_),
                   "we_down": (E, F_, D)})
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F_
        shapes.update({"ws_gate": (D, Fs), "ws_up": (D, Fs), "ws_down": (Fs, D)})
    return shapes


def _stack_shapes(cfg: LMConfig) -> Dict[str, Dict[str, tuple]]:
    out = {}
    if cfg.moe:
        out["moe"] = _moe_layer_shapes(cfg)
        if cfg.moe_layer_step == 2 or cfg.first_k_dense:
            out["dense"] = _dense_layer_shapes(cfg)
    else:
        out["dense"] = _dense_layer_shapes(cfg)
    return out


def _stack_units(cfg: LMConfig) -> Dict[str, int]:
    """Each stack's units: every stack has one a unit, but the leading
    dense layers, which are a stack of their own before the MoE stack."""
    if cfg.first_k_dense:
        return {"dense": cfg.first_k_dense, "moe": cfg.n_moe_layers}
    return {stack: cfg.n_units for stack in _stack_shapes(cfg)}


#: Leaves kept in float32 whatever ``param_dtype`` is: the sigmoid router's
#: choice bias (``e_score_correction_bias``), which only picks experts.
FLOAT32_LEAVES = ("router_bias",)


class LMParams(Module):
    """The JAX tree ``{embed, ln_f, lm_head, dense: {...}, moe: {...}}`` as a
    module; each layer leaf stacked ``(U, ...)``."""

    def __init__(self, cfg: LMConfig, gen: Optional[torch.Generator],
                 device, draw: bool = True):
        super().__init__()
        empty = torch.device(device).type == "meta" or not draw

        def init_one(shape, scale=None):
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = scale if scale is not None else (1.0 / max(fan_in, 1)) ** 0.5
            if empty:
                return torch.empty(shape, dtype=cfg.param_dtype, device=device)
            return (torch.randn(shape, generator=gen, device=device)
                    * scale).to(cfg.param_dtype)

        def ones(shape, dtype=cfg.param_dtype):
            if empty:
                return torch.empty(shape, dtype=dtype, device=device)
            return torch.ones(shape, dtype=dtype, device=device)

        def leaf(name, shape):
            if name in FLOAT32_LEAVES:  # e_score_correction_bias: zeros
                return torch.zeros(shape, dtype=torch.float32, device=device)
            if name.startswith(("ln", "kv_norm")):
                return ones(shape)
            return init_one(shape)

        self.embed = torch.nn.Parameter(
            init_one((cfg.padded_vocab, cfg.d_model), scale=0.02))
        self.ln_f = torch.nn.Parameter(ones((cfg.d_model,)))
        self.lm_head = torch.nn.Parameter(
            init_one((cfg.d_model, cfg.padded_vocab)))
        units = _stack_units(cfg)
        for stack, shapes in _stack_shapes(cfg).items():
            U = units[stack]
            self.add_module(stack, torch.nn.ParameterDict({
                name: leaf(name, (U,) + shape)
                for name, shape in shapes.items()}))

    def stacks(self) -> Dict[str, torch.nn.ParameterDict]:
        return {k: getattr(self, k) for k in ("dense", "moe")
                if hasattr(self, k)}


def init_params(cfg: LMConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda", seed: int = 0, draw: bool = True) -> LMParams:
    """JAX's init: N(0, 1 / fan_in) weights (0.02 for ``embed``), ones for
    the norms, in ``param_dtype`` (a sigmoid router's choice bias zeros in
    float32), drawn from ``gen`` (default: a generator on ``device``
    seeded with ``seed``). On ``device="meta"``, or with ``draw=False``,
    the tensors are allocated and nothing is drawn or written (llama3-405b
    and Maverick on ``meta``, as JAX's ``eval_shape``; a caller that
    writes every leaf itself)."""
    if gen is None and draw and torch.device(device).type != "meta":
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return LMParams(cfg, gen, device, draw)


def _units(cfg: LMConfig, params: LMParams
           ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """The per-unit parameters ``[{stack: {name: tensor}}]``: each stack
    unbound once. Leading dense layers are units of their own, before the
    MoE stack's."""
    unbound = {stack: {name: t.unbind(0) for name, t in pd.items()}
               for stack, pd in params.stacks().items()}
    if cfg.first_k_dense:
        return [{stack: {name: ts[u] for name, ts in unbound[stack].items()}}
                for stack in ("dense", "moe")
                for u in range(_stack_units(cfg)[stack])]
    return [{stack: {name: ts[u] for name, ts in names.items()}
             for stack, names in unbound.items()}
            for u in range(cfg.n_units)]


def single_device_only(cfg: LMConfig, form: str, mesh: bool = False) -> None:
    """Raise ``NotImplementedError`` where ``form`` would compute another
    model than ``cfg``: the KV cache, prefill and decode are written for
    GQA and the softmax router over units of one layout (decoding through
    an MLA latent cache is not written), and the mesh forms besides for
    the dense MoE oracle and the norms' default eps."""
    found = []
    if cfg.attention == "mla":
        found.append("MLA attention")
    if cfg.router == "sigmoid":
        found.append("the sigmoid router")
    if cfg.first_k_dense:
        found.append("leading dense layers")
    if mesh and cfg.moe_impl == "dispatched":
        found.append("the dispatched MoE")
    if mesh and cfg.norm_eps != 1e-6:
        found.append(f"norm eps {cfg.norm_eps}")
    if found:
        raise NotImplementedError(
            f"{form} of {cfg.name} is not written for {', '.join(found)}; "
            "its single-device forward and scoring are")


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), -1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float
          ) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        angles = positions.float()[:, None] * freqs[None, :]   # (S, half)
        angles = angles[None, :, None, :]
    else:
        angles = positions.float()[..., None] * freqs          # (B, S, half)
        angles = angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _rope_pairs(x: torch.Tensor, positions: torch.Tensor, theta: float
                ) -> torch.Tensor:
    """Rope on interleaved pairs, as modeling_deepseek applies it: the
    pairs ``(x[2i], x[2i + 1])`` are de-interleaved into halves, then
    rotated as :func:`_rope` rotates halves. The result is in the halves'
    layout, q's and k's alike, so their products are the pairs'."""
    Dr = x.shape[-1]
    x = x.unflatten(-1, (Dr // 2, 2)).transpose(-1, -2).flatten(-2)
    return _rope(x, positions, theta)


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, chunk: int, kv_offset: int = 0
                       ) -> torch.Tensor:
    """softmax(QK^T)V in float32 a block of ``chunk`` queries at a time, so
    the (Sq, Skv) scores never materialize.

    q, k, v: (B, H, S, Dh) with matching head counts (GQA's KV repeated by
    the caller). kv_offset: absolute position of q[0] minus kv[0]."""
    B, Hq, Sq, Dh = q.shape
    Skv = k.shape[2]
    scale = Dh ** -0.5
    chunk = min(chunk, Sq)
    pad = (-Sq) % chunk
    qp = F.pad(q, (0, 0, 0, pad)) if pad else q
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Skv, device=q.device)
    blocks = []
    for qi in range((Sq + pad) // chunk):
        q_blk = qp[:, :, qi * chunk:(qi + 1) * chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", q_blk.float(), kf) * scale
        if causal:
            q_pos = qi * chunk + torch.arange(chunk, device=q.device) + kv_offset
            mask = q_pos[:, None] >= k_pos[None, :]
            s = s.masked_fill(~mask[None, None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        blocks.append(o.to(q.dtype))
    return torch.cat(blocks, dim=2)[:, :, :Sq]


def _repeat_kv(cfg: LMConfig, t: torch.Tensor) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, H, Dh): each KV head once per query head
    of its group."""
    group = cfg.n_heads // cfg.n_kv_heads
    return t if group == 1 else t.repeat_interleave(group, dim=2)


def _decode_softmax(cfg: LMConfig, q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, index: int) -> torch.Tensor:
    """q (B, S, H, Dh) over the whole cache (B, S_max, Hkv, Dh), query s
    seeing positions up to ``index + s``: float32 scores, one softmax;
    (B, H, S, Dh) in ``cfg.dtype``."""
    S, S_max, Dh = q.shape[1], k_cache.shape[1], cfg.head_dim
    qt = q.transpose(1, 2)                                # (B, H, S, Dh)
    kt = _repeat_kv(cfg, k_cache).transpose(1, 2)         # (B, H, S_max, Dh)
    vt = _repeat_kv(cfg, v_cache).transpose(1, 2)
    s = torch.einsum("bhqd,bhkd->bhqk", qt.float(), kt.float()) * (Dh ** -0.5)
    valid = (torch.arange(S_max, device=q.device)[None, :]
             <= index + torch.arange(S, device=q.device)[:, None])
    s = s.masked_fill(~valid[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vt.float()).to(cfg.dtype)


def _attention_block(cfg: LMConfig, lp: Dict[str, torch.Tensor],
                     h: torch.Tensor, positions: torch.Tensor,
                     cache: Optional[Dict[str, torch.Tensor]] = None,
                     cache_index: Optional[int] = None):
    """Self-attention sublayer. Returns (out, cache entry): without a cache
    the prefill entry (B, S, Hkv, Dh); with one, the decode path writes the
    new keys and values into it in place at ``cache_index`` and returns
    it."""
    B, S, D = h.shape
    Dh = cfg.head_dim
    x = _rmsnorm(h, lp["ln1"], cfg.norm_eps)
    q = (x @ lp["wq"].to(cfg.dtype)).reshape(B, S, cfg.n_heads, Dh)
    k = (x @ lp["wk"].to(cfg.dtype)).reshape(B, S, cfg.n_kv_heads, Dh)
    v = (x @ lp["wv"].to(cfg.dtype)).reshape(B, S, cfg.n_kv_heads, Dh)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = _chunked_attention(q.transpose(1, 2),
                                 _repeat_kv(cfg, k).transpose(1, 2),
                                 _repeat_kv(cfg, v).transpose(1, 2),
                                 causal=True, chunk=cfg.attn_chunk)
        new_entry = {"k": k, "v": v}
    else:
        # decode: write S (=1) new kv at cache_index (dynamic_update_slice,
        # its start clamped as JAX's), attend over the prefix
        k_cache, v_cache = cache["k"], cache["v"]
        S_max = k_cache.shape[1]
        start = max(0, min(int(cache_index), S_max - S))
        k_cache[:, start:start + S] = k.to(k_cache.dtype)
        v_cache[:, start:start + S] = v.to(v_cache.dtype)
        out = _decode_softmax(cfg, q, k_cache, v_cache, int(cache_index))
        new_entry = {"k": k_cache, "v": v_cache}
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * Dh)
    return h + out @ lp["wo"].to(cfg.dtype), new_entry


def _mla_attention_block(cfg: LMConfig, lp: Dict[str, torch.Tensor],
                         h: torch.Tensor, positions: torch.Tensor
                         ) -> torch.Tensor:
    """DeepSeek's multi-head latent attention, without a q LoRA, as
    modeling_deepseek computes it: q from ``wq``; ``wkv_a`` to the latent
    (``kv_lora_rank`` wide) and one rope key of ``qk_rope_head_dim`` shared
    by every head; the latent RMS-normed (``kv_norm``) and lifted by
    ``wkv_b`` to each head's k without rope and its v. Rope on the rope
    dims only, on interleaved pairs (:func:`_rope_pairs`); q and k are
    ``qk_nope_head_dim + qk_rope_head_dim`` wide, so the softmax scale is
    that width to the -1/2 (no ``rope_scaling``), and v is
    ``v_head_dim`` wide."""
    B, S, _ = h.shape
    H, nope = cfg.n_heads, cfg.qk_nope_head_dim
    rope, vd, rank = cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    x = _rmsnorm(h, lp["ln1"], cfg.norm_eps)
    q = (x @ lp["wq"].to(cfg.dtype)).view(B, S, H, nope + rope)
    latent, k_pe = (x @ lp["wkv_a"].to(cfg.dtype)).split([rank, rope], -1)
    latent = _rmsnorm(latent, lp["kv_norm"], cfg.norm_eps)
    kv = (latent @ lp["wkv_b"].to(cfg.dtype)).view(B, S, H, nope + vd)
    k_nope, v = kv.split([nope, vd], -1)
    q_pe = _rope_pairs(q[..., nope:], positions, cfg.rope_theta)
    k_pe = _rope_pairs(k_pe.reshape(B, S, 1, rope), positions, cfg.rope_theta)
    q = torch.cat([q[..., :nope], q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], -1)
    out = _chunked_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=True,
                             chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, S, H * vd)
    return h + out @ lp["wo"].to(cfg.dtype)


def _dense_ffn(cfg: LMConfig, lp, h):
    x = _rmsnorm(h, lp["ln2"], cfg.norm_eps)
    gate = F.silu(x @ lp["w_gate"].to(cfg.dtype))
    up = x @ lp["w_up"].to(cfg.dtype)
    return h + (gate * up) @ lp["w_down"].to(cfg.dtype)


def _route(cfg: LMConfig, lp, xt: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(weights, experts)``, each ``(T, top_k)``, of the tokens ``xt``:
    the router's logits in float32. ``softmax``: the top-k probabilities,
    normalised. ``sigmoid`` (DeepSeek-V3's ``noaux_tc`` with one group):
    the experts chosen by score plus the float32 choice bias, their
    weights the scores without it, normalised, then scaled by
    ``routed_scaling_factor``."""
    logits = xt.float() @ lp["router"].float()
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        choice = scores + lp["router_bias"].float()
        top_i = torch.topk(choice, cfg.top_k, dim=-1).indices
        top_p = scores.gather(-1, top_i)
        if cfg.top_k > 1:
            top_p = top_p / (torch.sum(top_p, -1, keepdim=True) + 1e-20)
        return top_p * cfg.routed_scaling_factor, top_i
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True), min=1e-9)
    return top_p, top_i


def _shared_experts(cfg: LMConfig, lp, x, y):
    if not cfg.n_shared_experts:
        return y
    gate = F.silu(x @ lp["ws_gate"].to(cfg.dtype))
    up = x @ lp["ws_up"].to(cfg.dtype)
    return y + (gate * up) @ lp["ws_down"].to(cfg.dtype)


def _moe_ffn_dense(cfg: LMConfig, lp, h, route=None):
    """Exact (lossless) MoE: every expert over every token, one-hot
    combined, plus the shared expert (JAX's ``_moe_ffn`` without a mesh).
    ``route(cfg, lp, xt)`` defaults to :func:`_route`."""
    B, S, D = h.shape
    x = _rmsnorm(h, lp["ln2"], cfg.norm_eps)
    xt = x.reshape(B * S, D)
    top_p, top_i = (route or _route)(cfg, lp, xt)
    combine = torch.zeros(B * S, cfg.n_experts, dtype=torch.float32,
                          device=h.device)
    for k in range(cfg.top_k):
        combine = combine + (F.one_hot(top_i[:, k], cfg.n_experts).float()
                             * top_p[:, k:k + 1])
    y = torch.zeros(B * S, D, dtype=torch.float32, device=h.device)
    experts = zip(lp["we_gate"].unbind(0), lp["we_up"].unbind(0),
                  lp["we_down"].unbind(0))
    for e, (wg, wu, wd) in enumerate(experts):
        hid = F.silu(xt @ wg.to(cfg.dtype)) * (xt @ wu.to(cfg.dtype))
        ye = (hid @ wd.to(cfg.dtype)).float()
        y = y + ye * combine[:, e:e + 1]
    y = y.reshape(B, S, D).to(cfg.dtype)
    return h + _shared_experts(cfg, lp, x, y)


def _moe_ffn_dispatched(cfg: LMConfig, lp, h, route=None):
    """The same MoE, dropless, over the routed token-slots alone: the
    ``(token, k)`` slots sorted by expert on the device (no host sync),
    the held experts' gate, up and down projections as three grouped
    products (:func:`repro_torch.kernels.grouped_mm.grouped_mm`) with SiLU
    times up between, the rows put back in slot order and each token's
    ``top_k`` rows summed with their weights in float32 (no atomics), then
    the shared experts."""
    from repro_torch.kernels.grouped_mm import grouped_mm

    B, S, D = h.shape
    x = _rmsnorm(h, lp["ln2"], cfg.norm_eps)
    xt = x.reshape(B * S, D)
    top_p, top_i = (route or _route)(cfg, lp, xt)
    T, k = top_i.shape
    flat = top_i.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int32,
                         device=h.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))  # bincount syncs
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    rows = xt.index_select(0, order // k)
    gate = grouped_mm(rows, lp["we_gate"].to(cfg.dtype), ends)
    up = grouped_mm(rows, lp["we_up"].to(cfg.dtype), ends)
    out = grouped_mm(F.silu(gate) * up, lp["we_down"].to(cfg.dtype), ends)
    slots = torch.empty_like(out).index_copy_(0, order, out).view(T, k, D)
    y = torch.bmm(top_p.unsqueeze(1), slots.float()).view(B, S, D)
    return h + _shared_experts(cfg, lp, x, y.to(cfg.dtype))


def _sub_kinds(cfg: LMConfig) -> List[str]:
    """The stack each layer of a unit reads, in order."""
    if cfg.moe and cfg.moe_layer_step == 2:
        return ["dense", "moe"]
    return ["moe" if cfg.moe else "dense"]


def _ffn(cfg: LMConfig, kind: str, lp, h):
    if kind != "moe":
        return _dense_ffn(cfg, lp, h)
    if cfg.moe_impl == "dispatched":
        return _moe_ffn_dispatched(cfg, lp, h)
    return _moe_ffn_dense(cfg, lp, h)


def _unit_body(cfg: LMConfig, h, positions, unit_params, collect_kv=False):
    """One unit: (step-1) dense layers then the MoE/dense layer (a leading
    dense layer is a unit of its own). The attention and MoE sublayers are
    detail spans on the global recorder, ``lm.attention`` and ``lm.moe``."""
    rec = get_recorder()
    entries = []
    for kind in ("dense", "moe"):
        if kind not in unit_params:
            continue
        lp = unit_params[kind]
        with rec.span("lm.attention", detail=True):
            if cfg.attention == "mla":
                h = _mla_attention_block(cfg, lp, h, positions)
            else:
                h, e = _attention_block(cfg, lp, h, positions)
                entries.append(e)
        if kind == "moe":
            with rec.span("lm.moe", detail=True):
                h = _ffn(cfg, kind, lp, h)
        else:
            h = _ffn(cfg, kind, lp, h)
    return (h, entries) if collect_kv else h


def _run_units(cfg: LMConfig, units, h, positions, unit_body=None):
    """The unit stack, with JAX's remat: each unit checkpointed, and with
    ``scan_chunks`` a chunk of checkpointed units checkpointed again.
    ``unit_body(h, positions, unit_params)`` defaults to this module's."""
    remat = cfg.remat and torch.is_grad_enabled()
    unit = unit_body or functools.partial(_unit_body, cfg)

    def body(h, up):
        if remat:
            return checkpoint(functools.partial(unit, positions=positions,
                                                unit_params=up), h,
                              use_reentrant=False)
        return unit(h, positions=positions, unit_params=up)

    def run(h, chunk_units):
        for up in chunk_units:
            h = body(h, up)
        return h

    u1 = cfg.scan_chunks
    if u1 and u1 > 1 and cfg.n_units % u1 == 0:
        u2 = cfg.n_units // u1
        for c in range(u1):
            chunk_units = units[c * u2:(c + 1) * u2]
            if remat:
                h = checkpoint(functools.partial(run, chunk_units=chunk_units),
                               h, use_reentrant=False)
            else:
                h = run(h, chunk_units)
        return h
    return run(h, units)


def _embed(cfg: LMConfig, params: LMParams, tokens: torch.Tensor):
    return F.embedding(tokens.long(), params.embed).to(cfg.dtype)


def hidden(cfg: LMConfig, params: LMParams, tokens: torch.Tensor
           ) -> torch.Tensor:
    """tokens (B, S) -> the final normed hidden states (B, S, d_model)."""
    S = tokens.shape[1]
    h = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=h.device)
    h = _run_units(cfg, _units(cfg, params), h, positions)
    return _rmsnorm(h, params.ln_f, cfg.norm_eps)


def forward(cfg: LMConfig, params: LMParams, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab). With ``mesh``: this
    rank's rows of the batch and of the logits, its vocabulary block where
    ``lm_head`` is split over ``model`` (see :mod:`.sharded`)."""
    if mesh is not None:
        from repro_torch.models.lm import sharded

        return sharded.forward(cfg, params, tokens, mesh)
    return hidden(cfg, params, tokens) @ params.lm_head.to(cfg.dtype)


def next_token_logp(cfg: LMConfig, params: LMParams, h: torch.Tensor,
                    tokens: torch.Tensor, block: int) -> torch.Tensor:
    """``(B, S - 1)`` float32 log P of each next token ``tokens[:, 1:]``
    from the final hidden states ``h`` (B, S, d_model): the head's logits
    ``block`` rows at a time (the (B, S, vocab) logits never materialize),
    a float32 log-softmax over the unpadded vocabulary."""
    B, S, D = h.shape
    rows = h[:, :-1].reshape(-1, D)
    targets = tokens[:, 1:].reshape(-1, 1).long()
    head = params.lm_head.to(cfg.dtype)
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=h.device)
    for lo in range(0, rows.shape[0], block):
        logits = (rows[lo:lo + block] @ head).float()[:, :cfg.vocab]
        out[lo:lo + block] = (logits.gather(1, targets[lo:lo + block])[:, 0]
                              - torch.logsumexp(logits, -1))
    return out.view(B, S - 1)


def _mask_padded_vocab(cfg: LMConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return logits.masked_fill(~valid, float("-inf"))


def lm_loss(cfg: LMConfig, params: LMParams, batch, mesh=None
            ) -> torch.Tensor:
    """The masked mean next-token NLL (targets < 0 masked). With ``mesh``:
    the global batch's, from this rank's rows, on every rank."""
    if mesh is not None:
        from repro_torch.models.lm import sharded

        return sharded.lm_loss(cfg, params, batch, mesh)
    logits = forward(cfg, params, batch["tokens"])
    logits = _mask_padded_vocab(cfg, logits.float())
    targets = batch["targets"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(targets, min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (targets >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _row_blocks(batch, M: int):
    """The batch's M row blocks, in order."""
    micro = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:])
             for k, v in batch.items()}
    return [{k: v[i] for k, v in micro.items()} for i in range(M)]


def make_train_step(cfg: LMConfig, optimizer=None, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state, loss)``.

    With ``cfg.microbatches`` M > 1 the batch is split into M row blocks
    and their gradients summed in ``grad_accum_dtype`` (each sum in
    float32, as JAX's scan), then divided by M. The parameters are updated
    in place and returned; the loss is a device tensor. With ``mesh`` the
    step takes this rank's shards (:func:`.sharded.place_params`) and rows
    of the global batch, the loss is the global one and microbatch m is
    the global rows ``[m B / M, (m + 1) B / M)`` (:mod:`.sharded`); every
    gradient comes out of the backward already summed over the ranks."""
    optimizer = optimizer or optim_lib.adamw(3e-4)
    if cfg.moe_impl == "dispatched":
        raise NotImplementedError(
            f"the train step of {cfg.name}: the dispatched MoE is written "
            "for scoring only")
    if mesh is None:
        loss_fn = functools.partial(lm_loss, cfg)
        split = _row_blocks
    else:
        from repro_torch.models.lm import sharded

        lay = sharded._Layout(cfg, mesh)
        loss_fn = functools.partial(sharded._loss, lay)
        split = functools.partial(sharded._microbatches, lay)

    def train_step(params, opt_state, batch):
        plist = list(params.parameters())
        M = cfg.microbatches
        if M == 1:
            loss = loss_fn(params, batch)
            grads = list(torch.autograd.grad(loss, plist))
            loss = loss.detach()
        else:
            grads = [torch.zeros(p.shape, dtype=cfg.grad_accum_dtype,
                                 device=p.device) for p in plist]
            loss = torch.zeros((), dtype=torch.float32, device=plist[0].device)
            for mb in split(batch, M):
                mb_loss = loss_fn(params, mb)
                for acc, g in zip(grads, torch.autograd.grad(mb_loss, plist)):
                    if acc.dtype == torch.float32:
                        acc.add_(g)
                    else:
                        acc.copy_(acc.float() + g.float())
                loss = loss + mb_loss.detach()
            loss = loss / M
            for acc in grads:
                acc.div_(M)
        opt_state = optim_lib.step(optimizer, grads, opt_state, plist)
        return params, opt_state, loss

    return train_step


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: Optional[int] = None,
               dtype=None, device="cuda", mesh=None, dp_axes=None
               ) -> Dict[str, torch.Tensor]:
    """A zero cache ``(U, sub, batch, max_seq, Hkv, Dh)``; with ``mesh``
    this rank's block of it: the batch over ``dp_axes`` (default the data
    axes), the sequence over ``cfg.decode_seq_axes``."""
    single_device_only(cfg, "the KV cache")
    S = max_seq or cfg.max_seq
    dtype = dtype or cfg.dtype
    if mesh is not None:
        from repro_torch.models.lm import sharded

        batch, S = sharded.local_cache_dims(cfg, mesh, batch, S, dp_axes)
    shape = (cfg.n_units, cfg.layers_per_unit, batch, S, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def make_prefill_step(cfg: LMConfig, mesh=None, dp_axes=None):
    """prefill(params, tokens (B, S)) -> (last-position logits (B, 1, V),
    cache (U, sub, B, S, Hkv, Dh)): the layer stack once over the prompt,
    without a gradient; the (B, S, V) logits never materialize. With
    ``mesh``: this rank's rows, the cache in ``cache_specs``' placement
    (:func:`.sharded.make_prefill_step`)."""
    single_device_only(cfg, "prefill")
    if mesh is not None:
        from repro_torch.models.lm import sharded

        return sharded.make_prefill_step(cfg, mesh, dp_axes)

    @torch.no_grad()
    def prefill(params, tokens):
        B, S = tokens.shape
        h = _embed(cfg, params, tokens)
        positions = torch.arange(S, device=h.device)
        cache = init_cache(cfg, B, S, device=h.device)
        for u, up in enumerate(_units(cfg, params)):
            h, entries = _unit_body(cfg, h, positions, up, collect_kv=True)
            for sub, e in enumerate(entries):
                cache["k"][u, sub] = e["k"]
                cache["v"][u, sub] = e["v"]
        h_last = _rmsnorm(h[:, -1:], params.ln_f)
        logits = h_last @ params.lm_head.to(cfg.dtype)
        return _mask_padded_vocab(cfg, logits), cache

    return prefill


def make_decode_step(cfg: LMConfig, mesh=None, dp_axes=None):
    """decode_step(params, cache, tokens (B, 1), index) -> (logits (B, 1, V),
    cache): one token per row at position ``index``, whose keys and values
    are written into ``cache`` in place (the same dict comes back). With
    ``mesh``: this rank's rows and cache block
    (:func:`.sharded.make_decode_step`)."""
    single_device_only(cfg, "decode")
    if mesh is not None:
        from repro_torch.models.lm import sharded

        return sharded.make_decode_step(cfg, mesh, dp_axes)

    @torch.no_grad()
    def decode_step(params, cache, tokens, index):
        B = tokens.shape[0]
        index = int(index)
        h = _embed(cfg, params, tokens)
        positions = torch.full((B, 1), index, dtype=torch.int32,
                               device=h.device)
        for u, up in enumerate(_units(cfg, params)):
            for sub, kind in enumerate(_sub_kinds(cfg)):
                entry = {"k": cache["k"][u, sub], "v": cache["v"][u, sub]}
                h, _ = _attention_block(cfg, up[kind], h, positions,
                                        cache=entry, cache_index=index)
                h = _ffn(cfg, kind, up[kind], h)
        h = _rmsnorm(h, params.ln_f)
        logits = h @ params.lm_head.to(cfg.dtype)
        return _mask_padded_vocab(cfg, logits), cache

    return decode_step
