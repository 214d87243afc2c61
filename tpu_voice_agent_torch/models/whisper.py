"""Whisper-family speech encoder-decoder in PyTorch.

Port of ``tpu_voice_agent/models/whisper.py``: the same parameter tree
(layers stacked on a leading axis, convolution weights in JAX's (3, Cin,
Cout) "WIO" layout), the same pre-LN encoder and decoder, logits tied to the
token embedding. Plain functions on tensors; the caller picks the device.

Differences from the JAX module, all deliberate:
- The conv front end is one matmul over three shifted copies of its input
  (im2col) against the WIO weight reshaped to (3 Cin, Cout), with JAX's
  "SAME" padding: (1, 1) for ``conv1`` and, at an even frame count, (0, 1)
  for the stride-2 ``conv2`` (PyTorch's ``padding=1`` would read other
  samples). A matmul keeps fp32 weights in full fp32 on the card, where
  cuDNN would take a convolution through TF32.
- GELU is the tanh approximation everywhere (``jax.nn.gelu``'s default).
- ``decoder_forward`` writes the new self-attention k/v into the stacked
  cache IN PLACE (JAX returns an updated copy); layer loops are Python loops
  over per-layer views, not ``lax.scan``.
- With ``attn_impl="kernels"`` the encoder's self-attention is K1
  (non-causal) and every T = 1 decoder step's self- and cross-attention is
  K5 over the layer's flat cache planes, as the JAX module's
  ``attn_impl="pallas"``; T > 1 keeps the plain masked attention.
Left out: ``init_cross_kv_pool`` and ``pad_cross_kv`` (the batched STT
plane).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import decode_attention, flash_attention

_NEG_INF = -1e30


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 4096
    n_mels: int = 80
    d_model: int = 384
    n_heads: int = 6
    enc_layers: int = 4
    dec_layers: int = 4
    max_audio_frames: int = 3000  # mel frames (30 s); encoder halves this
    max_text_len: int = 448
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.d_model

    @property
    def enc_positions(self) -> int:
        return self.max_audio_frames // 2


PRESETS: dict[str, WhisperConfig] = {
    "whisper-test": WhisperConfig(d_model=64, n_heads=4, enc_layers=2, dec_layers=2,
                                  max_audio_frames=200, max_text_len=64),
    "whisper-tiny": WhisperConfig(d_model=384, n_heads=6, enc_layers=4, dec_layers=4),
    "whisper-base": WhisperConfig(d_model=512, n_heads=8, enc_layers=6, dec_layers=6),
    "whisper-small": WhisperConfig(d_model=768, n_heads=12, enc_layers=12, dec_layers=12),
    "whisper-large-v3": WhisperConfig(d_model=1280, n_heads=20, enc_layers=32, dec_layers=32,
                                      n_mels=128),
}


# ---------------------------------------------------------------- params


def init_params(cfg: WhisperConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device: str | torch.device | None = None) -> dict:
    """Random init with the JAX module's shapes and scales (normal draws in
    fp32, scaled by fan-in ** -0.5 or 0.02, cast to ``dtype``; biases zero,
    norms one). The numbers differ from ``jax.random``'s; tests share
    weights through ``bridge`` instead. ``device`` defaults to the
    generator's."""
    device = device if device is not None else generator.device
    d, f, hd, nh = cfg.d_model, cfg.ffn_dim, cfg.head_dim, cfg.n_heads

    def w(*shape, scale=None):
        scale = scale if scale is not None else (shape[-2] ** -0.5 if len(shape) >= 2 else 0.02)
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ln(*shape):
        return {"g": torch.ones(shape, device=device, dtype=dtype), "b": zeros(*shape)}

    def attn_block(L):
        return {"wq": w(L, d, nh * hd), "wk": w(L, d, nh * hd), "wv": w(L, d, nh * hd),
                "wo": w(L, nh * hd, d), "bq": zeros(L, nh * hd), "bv": zeros(L, nh * hd),
                "bo": zeros(L, d)}

    Le, Ld = cfg.enc_layers, cfg.dec_layers
    return {
        "encoder": {
            "conv1": {"w": w(3, cfg.n_mels, d), "b": zeros(d)},
            "conv2": {"w": w(3, d, d), "b": zeros(d)},
            "layers": {"ln1": ln(Le, d), "attn": attn_block(Le), "ln2": ln(Le, d),
                       "w1": w(Le, d, f), "b1": zeros(Le, f), "w2": w(Le, f, d),
                       "b2": zeros(Le, d)},
            "ln_post": ln(d),
        },
        "decoder": {
            "tok_emb": w(cfg.vocab_size, d, scale=0.02),
            "pos_emb": w(cfg.max_text_len, d, scale=0.02),
            "layers": {"ln1": ln(Ld, d), "self_attn": attn_block(Ld), "ln2": ln(Ld, d),
                       "cross_attn": attn_block(Ld), "ln3": ln(Ld, d),
                       "w1": w(Ld, d, f), "b1": zeros(Ld, f), "w2": w(Ld, f, d),
                       "b2": zeros(Ld, d)},
            "ln_final": ln(d),
        },
    }


def unstack_layers(layers):
    """Per-layer views (no copies) of a stacked layer tree; a list passes
    through. The layer loops index these instead of re-slicing every leaf on
    every call."""
    if isinstance(layers, list):
        return layers

    def pick(tree, i):
        return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    first = layers
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [pick(layers, i) for i in range(first.shape[0])]


def with_unstacked_layers(params: dict) -> dict:
    """The param tree with the encoder's and decoder's layers as per-layer
    view lists (what an engine keeps between calls)."""
    return {part: {**params[part], "layers": unstack_layers(params[part]["layers"])}
            for part in ("encoder", "decoder")}


def param_count(cfg: WhisperConfig) -> int:
    d, f = cfg.d_model, cfg.ffn_dim
    enc = 3 * cfg.n_mels * d + 3 * d * d + cfg.enc_layers * (4 * d * d + 2 * d * f)
    dec = cfg.vocab_size * d + cfg.max_text_len * d + cfg.dec_layers * (8 * d * d + 2 * d * f)
    return enc + dec


# ---------------------------------------------------------------- ops


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["g"] + p["b"]


def _sinusoid_pos(n_pos: int, d: int) -> np.ndarray:
    """Whisper-style sinusoidal position table (n_pos, d)."""
    log_timescale = np.log(10_000.0) / (d // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(d // 2))
    scaled = np.arange(n_pos)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


@lru_cache(maxsize=8)
def _pos_table(n_pos: int, d: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_sinusoid_pos(n_pos, d)).to(device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _proj(x, w, b=None):
    """``x @ w`` rounded to x's dtype, plus the bias in that dtype."""
    y = torch.matmul(x, w)
    return y + b if b is not None else y


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int):
    """JAX ``conv_general_dilated(x, w, (stride,), "SAME")`` in NWC / WIO /
    NWC: x (B, T, Cin), w (K, Cin, Cout) -> (B, ceil(T / stride), Cout) + b,
    as one matmul over the K shifted (and strided) input copies."""
    B, T, cin = x.shape
    K = w.shape[0]
    out = -(-T // stride)
    total = max((out - 1) * stride + K - T, 0)
    lo = total // 2
    xp = F.pad(x, (0, 0, lo, total - lo))
    span = (out - 1) * stride + 1
    cols = torch.cat([xp[:, k:k + span:stride] for k in range(K)], dim=-1)  # (B, out, K Cin)
    return torch.matmul(cols, w.reshape(K * cin, -1)) + b


def _mha(q, k, v, mask, nh: int, hd: int):
    """Plain attention as the JAX module's ``_mha`` / decoder branches have
    it: q (B,Tq,D), k/v (B,Tk,D) -> (B,Tq,D); fp32 scores, -1e30 masking,
    probabilities rounded to v's dtype before the value product. ``mask``
    (B, Tq, Tk) bool or None."""
    B, Tq, _ = q.shape
    Tk = k.shape[1]
    scores = torch.einsum("bqnh,bknh->bnqk", q.reshape(B, Tq, nh, hd).float(),
                          k.reshape(B, Tk, nh, hd).float()) * (hd**-0.5)
    if mask is not None:
        scores = torch.where(mask[:, None], scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bknh->bqnh", probs.float(), v.reshape(B, Tk, nh, hd).float())
    return out.reshape(B, Tq, nh * hd).to(q.dtype)


# ---------------------------------------------------------------- encoder


@torch.no_grad()
def encoder_forward(params: dict, cfg: WhisperConfig, mel: torch.Tensor,
                    attn_impl: str = "kernels", pos_offset: int | None = None) -> torch.Tensor:
    """mel (B, T, n_mels) -> (B, ceil(T / 2), d_model).

    ``pos_offset`` (encoder frames) places this block's sinusoidal positions
    at its offset inside the utterance (the incremental streaming path); the
    start is clamped so the slice fits the table, as ``dynamic_slice`` does.
    ``attn_impl="kernels"`` runs self-attention through K1 (non-causal),
    ``"torch"`` through the plain ``_mha``."""
    p = params["encoder"]
    x = _gelu(_conv1d_same(mel.to(p["conv1"]["w"].dtype), p["conv1"]["w"], p["conv1"]["b"], 1))
    x = _gelu(_conv1d_same(x, p["conv2"]["w"], p["conv2"]["b"], 2))
    B, T2, _ = x.shape
    table = _pos_table(cfg.enc_positions, cfg.d_model, x.device)
    start = 0 if pos_offset is None else min(max(int(pos_offset), 0), cfg.enc_positions - T2)
    x = x + table[start:start + T2].to(x.dtype)[None]

    nh, hd = cfg.n_heads, cfg.head_dim
    for lp in unstack_layers(p["layers"]):
        h = layer_norm(x, lp["ln1"], cfg.norm_eps)
        a = lp["attn"]
        q = _proj(h, a["wq"], a["bq"])
        k = _proj(h, a["wk"])
        v = _proj(h, a["wv"], a["bv"])
        if attn_impl == "kernels":
            attn = flash_attention(q.reshape(B, T2, nh, hd), k.reshape(B, T2, nh, hd),
                                   v.reshape(B, T2, nh, hd), causal=False).reshape(B, T2, -1)
        else:
            attn = _mha(q, k, v, None, nh, hd)
        x = x + _proj(attn, a["wo"], a["bo"])
        h = layer_norm(x, lp["ln2"], cfg.norm_eps)
        h = _gelu(_proj(h, lp["w1"], lp["b1"]))
        x = x + _proj(h, lp["w2"], lp["b2"])
    return layer_norm(x, p["ln_post"], cfg.norm_eps)


# ---------------------------------------------------------------- decoder


def init_self_cache(cfg: WhisperConfig, batch: int, dtype=torch.bfloat16,
                    device: str | torch.device = "cpu") -> dict:
    shape = (cfg.dec_layers, batch, cfg.max_text_len, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cross_kv_pool(cfg: WhisperConfig, slots: int, dtype=torch.bfloat16,
                       device: str | torch.device = "cpu") -> dict:
    """The batched STT plane's slotted cross-attention pool: one (L, S,
    enc_positions, nh, hd) buffer whose slot axis is the batched decode's
    batch axis. A live utterance owns one slot; its valid frames are a
    host-side ``enc_len`` the decode passes as the slot's kv_len, so stale
    positions past it are never read and a reused slot needs no zeroing."""
    shape = (cfg.dec_layers, slots, cfg.enc_positions, cfg.n_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def pad_cross_kv(cross_kv: dict, total: int) -> dict:
    """Zero-pad cross-KV along the encoder-position axis to ``total``, so
    the batched plane mixes ragged buckets in one fixed-shape decode (the
    padding lies past the row's kv_len and is never read)."""
    T = cross_kv["k"].shape[2]
    if T == total:
        return cross_kv
    if T > total:
        raise ValueError(f"cross-KV length {T} exceeds pad target {total}")
    pad = (0, 0, 0, 0, 0, total - T)
    return {"k": torch.nn.functional.pad(cross_kv["k"], pad),
            "v": torch.nn.functional.pad(cross_kv["v"], pad)}


@torch.no_grad()
def compute_cross_kv(params: dict, cfg: WhisperConfig, enc_out: torch.Tensor) -> dict:
    """Per-layer cross-attention K/V of the encoder output, (L, B, T_enc,
    nh, hd) each, computed once per utterance: k = enc @ wk, v = enc @ wv +
    bv with the bias added before rounding to the activation dtype, as the
    JAX module's fp32 accumulation has it."""
    layers = unstack_layers(params["decoder"]["layers"])
    B, T, _ = enc_out.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    ks, vs = [], []
    for lp in layers:
        a = lp["cross_attn"]
        ks.append(torch.matmul(enc_out, a["wk"]).reshape(B, T, nh, hd))
        v = torch.matmul(enc_out, a["wv"]).float() + a["bv"].float()
        vs.append(v.to(enc_out.dtype).reshape(B, T, nh, hd))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


@torch.no_grad()
def decoder_forward(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,  # (B, T) int
    positions: torch.Tensor,  # (B, T) int
    self_cache: dict,  # (L, B, S, nh, hd), written in place
    cross_kv: dict,  # (L, B, T_enc, nh, hd)
    enc_len: torch.Tensor,  # (B,) int32 valid encoder frames (a prefix)
    attn_impl: str = "kernels",  # "kernels" | "torch"
) -> tuple[torch.Tensor, dict]:
    """Returns logits (B, T, V) float32 and the self cache (the same
    tensors, written in place). Valid encoder frames are the prefix
    ``[0, enc_len[b])`` (the JAX module's prefix-shaped ``enc_mask``). With
    ``attn_impl="kernels"`` a T = 1 step attends through K5: self-attention
    with kv_len = frontier + 1 on ``cache[l]``, cross-attention with kv_len =
    enc_len on ``cross_kv[l]``."""
    p = params["decoder"]
    B, T = tokens.shape
    S = self_cache["k"].shape[2]
    T_enc = cross_kv["k"].shape[2]
    nh, hd = cfg.n_heads, cfg.head_dim
    dev = tokens.device

    pos_l = positions.long()
    x = p["tok_emb"][tokens.long()] + p["pos_emb"][pos_l.clamp(0, cfg.max_text_len - 1)]
    frontier = pos_l.amax(dim=1)
    use_kernel_step = attn_impl == "kernels" and T == 1
    if use_kernel_step:
        self_len = (frontier + 1).to(torch.int32)
        cross_len = enc_len.to(torch.int32)
    else:
        slots = torch.arange(S, device=dev)
        self_mask = ((slots[None, None, :] <= pos_l[:, :, None])
                     & (slots[None, :] <= frontier[:, None])[:, None, :])
        enc_valid = torch.arange(T_enc, device=dev)[None, :] < enc_len[:, None]
        cross_mask = enc_valid[:, None, :].expand(B, T, T_enc)
    rows = torch.arange(B, device=dev)[:, None]
    kc, vc = self_cache["k"], self_cache["v"]
    ck, cv = cross_kv["k"], cross_kv["v"]

    for li, lp in enumerate(unstack_layers(p["layers"])):
        h = layer_norm(x, lp["ln1"], cfg.norm_eps)
        a = lp["self_attn"]
        q = _proj(h, a["wq"], a["bq"])
        k = _proj(h, a["wk"])
        v = _proj(h, a["wv"], a["bv"])
        kc[li][rows, pos_l] = k.reshape(B, T, nh, hd).to(kc.dtype)
        vc[li][rows, pos_l] = v.reshape(B, T, nh, hd).to(vc.dtype)
        if use_kernel_step:
            attn = decode_attention(q.reshape(B, nh, hd), kc[li], vc[li], self_len)
            attn = attn.reshape(B, T, nh * hd).to(x.dtype)
        else:
            attn = _mha(q, kc[li].reshape(B, S, -1), vc[li].reshape(B, S, -1), self_mask, nh, hd)
        x = x + _proj(attn, a["wo"], a["bo"])

        h = layer_norm(x, lp["ln2"], cfg.norm_eps)
        ca = lp["cross_attn"]
        qc = _proj(h, ca["wq"], ca["bq"])
        if use_kernel_step:
            attn = decode_attention(qc.reshape(B, nh, hd), ck[li], cv[li], cross_len)
            attn = attn.reshape(B, T, nh * hd).to(x.dtype)
        else:
            attn = _mha(qc, ck[li].reshape(B, T_enc, -1), cv[li].reshape(B, T_enc, -1),
                        cross_mask, nh, hd)
        x = x + _proj(attn, ca["wo"], ca["bo"])

        h = layer_norm(x, lp["ln3"], cfg.norm_eps)
        h = _gelu(_proj(h, lp["w1"], lp["b1"]))
        x = x + _proj(h, lp["w2"], lp["b2"])
    x = layer_norm(x, p["ln_final"], cfg.norm_eps)
    logits = torch.matmul(x.float(), p["tok_emb"].float().t())
    return logits, self_cache

