"""HF-layout checkpoint directories for the port's checkpoint-import tests.

Small and seeded: a GPT-2-family (byte-level) ``tokenizer.json`` with merges
trained on the prompt corpus, a Llama ``config.json`` with weights in HF
naming, and a Whisper one whose tokenizer carries Whisper's control tokens.
Weights are written with the ``safetensors`` package (float32 unless a torch
dtype is asked for), which the port itself never imports.
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch

from tpu_voice_agent_torch.grammar.hf_tokenizer import _PRETOK, _byte_to_unicode
from tpu_voice_agent_torch.services.prompts import render_prompt

INTENT_JSON = ('{"version":"1.0","intents":[{"type":"back","target":null,"args":{},'
               '"priority":1,"requires_confirmation":false,"timeout_ms":15000,"retries":0}],'
               '"context_updates":{},"confidence":0.9,"tts_summary":null,'
               '"follow_up_question":null}')

CORPUS = [render_prompt("search for wireless headphones", {}),
          render_prompt("open the second result and extract the table", {"last_query": "x"}),
          INTENT_JSON]

WHISPER_SPECIALS = ("<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|transcribe|>",
                    "<|notimestamps|>", "<|0.00|>", "<|0.02|>")


def merge_pair(word, a, b) -> tuple:
    out, i = [], 0
    while i < len(word):
        if i + 1 < len(word) and word[i] == a and word[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(word[i])
            i += 1
    return tuple(out)


def train_merges(words: Counter, n: int) -> list[tuple[str, str]]:
    """Most-frequent-pair BPE merges over symbol tuples (count >= 2)."""
    merges: list[tuple[str, str]] = []
    work = dict(words)
    for _ in range(n):
        pairs: Counter = Counter()
        for w, c in work.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), cnt = pairs.most_common(1)[0]
        if cnt < 2:
            break
        merges.append((a, b))
        new: dict = {}
        for w, c in work.items():
            key = merge_pair(w, a, b)
            new[key] = new.get(key, 0) + c
        work = new
    return merges


def bytelevel_tokenizer(specials=("<|begin_of_text|>", "<|end_of_text|>"),
                        n_merges: int = 400) -> dict:
    """A GPT-2-family tokenizer.json object: 256 byte symbols, merges trained
    on the prompt corpus, then ``specials`` as added special tokens."""
    b2u = _byte_to_unicode()
    words: Counter = Counter()
    for t in CORPUS:
        for m in _PRETOK.finditer(t):
            words[tuple(b2u[b] for b in m.group(0).encode())] += 1
    merges = train_merges(words, n_merges)
    vocab = {b2u[b]: b for b in range(256)}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    n = len(vocab)
    return {"model": {"type": "BPE", "vocab": vocab,
                      "merges": [f"{a} {b}" for a, b in merges]},
            "pre_tokenizer": {"type": "ByteLevel"},
            "added_tokens": [{"id": n + i, "content": c, "special": True}
                             for i, c in enumerate(specials)]}


def write_shards(d, state: dict, n: int = 1, dtype=None) -> None:
    """``state`` as ``n`` shards ``model-0000k-of-0000n.safetensors``;
    ``dtype`` (torch) writes through ``safetensors.torch`` in that dtype."""
    names = sorted(state)
    for k in range(n):
        part = {nm: state[nm] for nm in names[k::n]}
        path = str(d / f"model-{k + 1:05d}-of-{n:05d}.safetensors")
        if dtype is None:
            save_file(part, path)
        else:
            save_torch({nm: torch.from_numpy(a).to(dtype) for nm, a in part.items()}, path)


def llama_config(vocab: int, dim: int = 64, layers: int = 2, heads: int = 4,
                 kv_heads: int = 2, ffn: int = 96, experts: int = 0) -> dict:
    cfg = {"vocab_size": vocab, "hidden_size": dim, "num_hidden_layers": layers,
           "num_attention_heads": heads, "num_key_value_heads": kv_heads,
           "intermediate_size": ffn, "max_position_embeddings": 4096,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-5}
    if experts:
        cfg.update(num_local_experts=experts, num_experts_per_tok=2)
    return cfg


def llama_state(cfg: dict, seed: int, head: bool = False, scale: float = 0.05) -> dict:
    """HF-named float32 weights for ``cfg`` ((out, in) layout)."""
    rng = np.random.default_rng(seed)
    V, D, F = cfg["vocab_size"], cfg["hidden_size"], cfg["intermediate_size"]
    NQ, NKV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    E, hd = cfg.get("num_local_experts", 0), D // cfg["num_attention_heads"]

    def w(*s):
        return rng.normal(0, scale, s).astype(np.float32)

    state = {"model.embed_tokens.weight": w(V, D), "model.norm.weight": 1 + w(D)}
    if head:
        state["lm_head.weight"] = w(V, D)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = 1 + w(D)
        state[p + "post_attention_layernorm.weight"] = 1 + w(D)
        state[p + "self_attn.q_proj.weight"] = w(NQ * hd, D)
        state[p + "self_attn.k_proj.weight"] = w(NKV * hd, D)
        state[p + "self_attn.v_proj.weight"] = w(NKV * hd, D)
        state[p + "self_attn.o_proj.weight"] = w(D, NQ * hd)
        if E:
            state[p + "block_sparse_moe.gate.weight"] = w(E, D)
            for e in range(E):
                q = f"{p}block_sparse_moe.experts.{e}."
                state[q + "w1.weight"], state[q + "w3.weight"] = w(F, D), w(F, D)
                state[q + "w2.weight"] = w(D, F)
        else:
            state[p + "mlp.gate_proj.weight"] = w(F, D)
            state[p + "mlp.up_proj.weight"] = w(F, D)
            state[p + "mlp.down_proj.weight"] = w(D, F)
    return state


def write_llama_checkpoint(d, seed: int = 3, pad: int = 8, shards: int = 2, experts: int = 0,
                           dtype=None, **widths) -> dict:
    """A complete HF Llama directory: config.json (vocab = the tokenizer's
    + ``pad``, a padded embedding table as real checkpoints have),
    tokenizer.json and the weights. Returns the config."""
    d.mkdir(parents=True, exist_ok=True)
    tok = bytelevel_tokenizer()
    (d / "tokenizer.json").write_text(json.dumps(tok))
    n_tok = max(t["id"] for t in tok["added_tokens"]) + 1
    cfg = llama_config(n_tok + pad, experts=experts, **widths)
    (d / "config.json").write_text(json.dumps(cfg))
    write_shards(d, llama_state(cfg, seed), shards, dtype)
    return cfg


def whisper_config(vocab: int, d_model: int = 64, heads: int = 4, layers: int = 2,
                   n_mels: int = 80, source: int = 100, target: int = 64) -> dict:
    return {"vocab_size": vocab, "d_model": d_model, "encoder_attention_heads": heads,
            "decoder_attention_heads": heads, "encoder_layers": layers,
            "decoder_layers": layers, "encoder_ffn_dim": 4 * d_model,
            "decoder_ffn_dim": 4 * d_model, "num_mel_bins": n_mels,
            "max_source_positions": source, "max_target_positions": target}


def whisper_state(cfg: dict, seed: int, loud_ids=(), scale: float = 0.05) -> dict:
    """HF-named float32 Whisper weights; the embedding rows of ``loud_ids``
    are scaled up 10x so greedy decode would pick them often (the logits
    are tied to the embedding), which the suppress mask must prevent."""
    rng = np.random.default_rng(seed)
    V, D, F = cfg["vocab_size"], cfg["d_model"], cfg["encoder_ffn_dim"]

    def w(*s):
        return rng.normal(0, scale, s).astype(np.float32)

    emb = w(V, D)
    emb[list(loud_ids)] *= 10.0
    state = {"model.encoder.conv1.weight": w(D, cfg["num_mel_bins"], 3),
             "model.encoder.conv1.bias": w(D),
             "model.encoder.conv2.weight": w(D, D, 3), "model.encoder.conv2.bias": w(D),
             "model.encoder.layer_norm.weight": 1 + w(D),
             "model.encoder.layer_norm.bias": w(D),
             "model.decoder.embed_tokens.weight": emb,
             "model.decoder.embed_positions.weight": w(cfg["max_target_positions"], D),
             "model.decoder.layer_norm.weight": 1 + w(D),
             "model.decoder.layer_norm.bias": w(D),
             "proj_out.weight": emb.copy()}  # HF's tied head: not read

    def attn(p):
        for k in ("q", "v", "out"):
            state[f"{p}.{k}_proj.weight"], state[f"{p}.{k}_proj.bias"] = w(D, D), w(D)
        state[f"{p}.k_proj.weight"] = w(D, D)

    def block(p, lns):
        for ln in lns:
            state[p + ln + ".weight"], state[p + ln + ".bias"] = 1 + w(D), w(D)
        state[p + ".fc1.weight"], state[p + ".fc1.bias"] = w(F, D), w(F)
        state[p + ".fc2.weight"], state[p + ".fc2.bias"] = w(D, F), w(D)

    for n in range(cfg["encoder_layers"]):
        p = f"model.encoder.layers.{n}"
        attn(p + ".self_attn")
        block(p, (".self_attn_layer_norm", ".final_layer_norm"))
    for n in range(cfg["decoder_layers"]):
        p = f"model.decoder.layers.{n}"
        attn(p + ".self_attn")
        attn(p + ".encoder_attn")
        block(p, (".self_attn_layer_norm", ".encoder_attn_layer_norm", ".final_layer_norm"))
    return state


def write_whisper_checkpoint(d, seed: int = 5, shards: int = 2, dtype=None, **widths) -> dict:
    """A complete HF Whisper directory: a byte-level tokenizer with Whisper's
    control tokens (the control rows loud in the embedding), config.json
    and the weights. Returns the config."""
    d.mkdir(parents=True, exist_ok=True)
    tok = bytelevel_tokenizer(specials=WHISPER_SPECIALS, n_merges=200)
    (d / "tokenizer.json").write_text(json.dumps(tok))
    ids = [t["id"] for t in tok["added_tokens"]]
    cfg = whisper_config(max(ids) + 1, **widths)
    (d / "config.json").write_text(json.dumps(cfg))
    # every control token but <|endoftext|> loud: unsuppressed, they win
    write_shards(d, whisper_state(cfg, seed, loud_ids=ids[1:]), shards, dtype)
    return cfg
