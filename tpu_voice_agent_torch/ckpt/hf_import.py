"""Hugging Face Llama / Mixtral / Whisper safetensors -> the port's param trees.

Port of ``tpu_voice_agent/ckpt/hf_import.py``. HF checkpoints store one tensor
per layer per projection in (out, in) layout; ``models/llama.py`` and
``models/whisper.py`` want layers stacked on a leading axis in (in, out)
matmul layout. The converters transpose and stack, with the JAX module's
layout choices: Mixtral's ``block_sparse_moe`` experts stacked into
``router`` / ``moe_gate`` / ``moe_up`` / ``moe_down``, a missing
``lm_head.weight`` tied to ``embed.T``, Whisper's conv kernels (out, in, k)
-> (k, in, out), its learned decoder ``embed_positions`` imported, its
encoder positions computed (sinusoidal, not read), the k projection without
bias and the output projection tied to the token embedding (``proj_out`` is
not read).

The safetensors format is read here, with ``json``, ``struct``, ``mmap`` and
``torch.frombuffer``: an 8-byte little-endian header length, the JSON header
(per tensor its ``dtype``, ``shape`` and ``data_offsets`` counted from the
end of the header; ``__metadata__`` aside), then the data. Every
``*.safetensors`` under a directory is read, sorted, so sharded checkpoints
load. F32, F16 and BF16 are read; any other dtype, a tensor missing, a
tensor in two shards, a data range that disagrees with its shape, or a shape
that disagrees with ``config.json`` raises, naming it.

``llama_from_hf_state(..., quant="int8")`` quantizes each stacked leaf one
layer at a time as it is read (``init_params``' discipline), so the tree at
``dtype`` is never held whole: a Mixtral-width checkpoint fits the card that
way. The result equals ``quantize_params`` of the unquantized tree bit for
bit (a per-out-channel scale lies inside one layer's plane).
"""

from __future__ import annotations

import glob
import json
import math
import mmap
import os
import struct

import numpy as np
import torch

from ..models.llama import LlamaConfig, quantize_leaf

# safetensors dtype tag -> torch dtype: the three a checkpoint of these
# families ships in
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


# ---------------------------------------------------------------- config.json


def _config_json(path) -> dict:
    path = str(path)
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no config.json at {path}")
    with open(path) as f:
        return json.load(f)


def llama_config_from_hf(path) -> LlamaConfig:
    """A LlamaConfig from an HF config.json (file or directory): dense
    Llama, or Mixtral with ``num_local_experts`` / ``num_experts_per_tok``.
    An imported MoE config gets the drop-free capacity E / K (at least
    1.25), which HF's config has no field for."""
    cfg = _config_json(path)
    E = cfg.get("num_local_experts", 0)
    K = cfg.get("num_experts_per_tok", 2)
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        dim=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        ffn_dim=cfg["intermediate_size"],
        max_seq_len=cfg.get("max_position_embeddings", 2048),
        rope_theta=float(cfg.get("rope_theta", 10_000.0)),
        norm_eps=float(cfg.get("rms_norm_eps", 1e-5)),
        n_experts=E,
        top_k=K,
        capacity_factor=max(1.25, E / K) if E else 1.25,
    )


def whisper_config_from_hf(path):
    """A WhisperConfig from an HF config.json (file or directory);
    ``num_mel_bins`` sets the mel front end (128 for large-v3)."""
    from ..models.whisper import WhisperConfig

    cfg = _config_json(path)
    return WhisperConfig(
        vocab_size=cfg["vocab_size"],
        n_mels=cfg.get("num_mel_bins", 80),
        d_model=cfg["d_model"],
        n_heads=cfg["encoder_attention_heads"],
        enc_layers=cfg["encoder_layers"],
        dec_layers=cfg["decoder_layers"],
        max_audio_frames=2 * cfg.get("max_source_positions", 1500),
        max_text_len=cfg.get("max_target_positions", 448),
    )


def check_hf_dir(path, knob: str) -> None:
    """Refuse, naming ``knob`` and the path, a directory that is not an HF
    checkpoint: missing, or without ``config.json``, ``tokenizer.json`` or
    a ``*.safetensors`` file."""
    path = str(path)
    if not os.path.isdir(path):
        raise ValueError(f"{knob}={path!r}: no such directory")
    for name in ("config.json", "tokenizer.json"):
        if not os.path.isfile(os.path.join(path, name)):
            raise ValueError(f"{knob}={path!r}: no {name} in the checkpoint directory")
    if not glob.glob(os.path.join(path, "*.safetensors")):
        raise ValueError(f"{knob}={path!r}: no *.safetensors in the checkpoint directory")


# ---------------------------------------------------------------- safetensors


def safetensors_files(path) -> list[str]:
    files = sorted(glob.glob(os.path.join(str(path), "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    return files


def _read_header(file: str) -> tuple[dict, int]:
    """(header dict, byte offset where the data starts)."""
    with open(file, "rb") as fh:
        raw = fh.read(8)
        if len(raw) != 8:
            raise ValueError(f"{file}: not a safetensors file (no header length)")
        (n,) = struct.unpack("<Q", raw)
        size = os.fstat(fh.fileno()).st_size
        if 8 + n > size:
            raise ValueError(f"{file}: header length {n} past the end of the file ({size} B)")
        try:
            header = json.loads(fh.read(n))
        except ValueError as e:
            raise ValueError(f"{file}: the safetensors header is not JSON ({e})") from None
    return header, 8 + n


def safetensors_shapes(path) -> dict[str, tuple[int, ...]]:
    """Tensor name -> shape from the headers only (no data read), over every
    ``*.safetensors`` under ``path``."""
    shapes: dict[str, tuple[int, ...]] = {}
    for f in safetensors_files(path):
        header, _ = _read_header(f)
        for name, meta in header.items():
            if name != "__metadata__":
                shapes[name] = tuple(meta["shape"])
    return shapes


class SafetensorsDir:
    """Lazy reader over a directory's shards: ``state[name]`` maps the
    tensor's bytes (``mmap``, copy-on-write, so the view is writable and the
    file is never touched) and returns a CPU tensor in its file dtype that
    views the map (valid until ``close``)."""

    def __init__(self, path):
        self.index: dict[str, tuple[str, str, tuple[int, ...], int, int]] = {}
        self._maps: dict[str, mmap.mmap] = {}
        for f in safetensors_files(path):
            header, start = _read_header(f)
            size = os.path.getsize(f)
            for name, meta in header.items():
                if name == "__metadata__":
                    continue
                if name in self.index:
                    raise ValueError(f"tensor {name} is in two shards: {self.index[name][0]} "
                                     f"and {f}")
                b, e = meta["data_offsets"]
                if not 0 <= b <= e or start + e > size:
                    raise ValueError(f"{name}: data_offsets {meta['data_offsets']} outside "
                                     f"{f}")
                self.index[name] = (f, meta["dtype"], tuple(meta["shape"]), start + b, start + e)

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def _map(self, file: str) -> mmap.mmap:
        m = self._maps.get(file)
        if m is None:
            with open(file, "rb") as fh:
                m = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
            self._maps[file] = m
        return m

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self.index:
            raise KeyError(f"HF checkpoint missing tensor {name}")
        file, tag, shape, b, e = self.index[name]
        dtype = SAFETENSORS_DTYPES.get(tag)
        if dtype is None:
            raise ValueError(f"{name}: dtype {tag} is not read (only "
                             f"{', '.join(SAFETENSORS_DTYPES)})")
        n = math.prod(shape)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if n * itemsize != e - b:
            raise ValueError(f"{name}: {e - b} data bytes for shape {shape} of {tag}")
        if n == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._map(file), dtype=dtype, count=n, offset=b).reshape(shape)

    def close(self) -> None:
        for m in self._maps.values():
            m.close()
        self._maps.clear()


def _state_reader(state):
    """A directory path -> a SafetensorsDir (closed by the caller); a dict
    of numpy arrays or tensors passes through."""
    if isinstance(state, (str, os.PathLike)):
        return SafetensorsDir(state), True
    return state, False


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


class _Getter:
    """``get(name, want, layout)`` -> the tensor on ``device`` at ``dtype``
    in the port's layout, its shape checked against ``want``."""

    def __init__(self, state, device, dtype):
        self.state, self.device, self.dtype = state, device, dtype

    def __call__(self, name: str, want: tuple[int, ...], layout: str = "") -> torch.Tensor:
        if name not in self.state:
            raise KeyError(f"HF checkpoint missing tensor {name}")
        t = _as_tensor(self.state[name]).to(self.device)
        if layout == "lin" and t.ndim == 2:
            t = t.t()
        elif layout == "conv":  # (out, in, k) -> (k, in, out)
            t = t.permute(2, 1, 0)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, config wants {tuple(want)}")
        # always a fresh contiguous tensor: never a view of a file map
        return t.to(dtype=self.dtype, memory_format=torch.contiguous_format, copy=True)


# ---------------------------------------------------------------- llama


def llama_hf_check(shapes: dict[str, tuple[int, ...]], cfg: LlamaConfig) -> None:
    """Validate an HF Llama / Mixtral checkpoint's tensor names and shapes
    against ``cfg`` from the headers alone (pairs with
    ``safetensors_shapes``). Raises with every mismatch (the first 20)."""
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    want: dict[str, tuple[int, ...]] = {
        "model.embed_tokens.weight": (cfg.vocab_size, d),
        "model.norm.weight": (d,),
    }
    per_layer = {
        "input_layernorm.weight": (d,),
        "self_attn.q_proj.weight": (nq * hd, d),
        "self_attn.k_proj.weight": (nkv * hd, d),
        "self_attn.v_proj.weight": (nkv * hd, d),
        "self_attn.o_proj.weight": (d, nq * hd),
        "post_attention_layernorm.weight": (d,),
    }
    if cfg.n_experts > 0:
        per_layer["block_sparse_moe.gate.weight"] = (cfg.n_experts, d)
        for e in range(cfg.n_experts):
            per_layer[f"block_sparse_moe.experts.{e}.w1.weight"] = (f, d)
            per_layer[f"block_sparse_moe.experts.{e}.w3.weight"] = (f, d)
            per_layer[f"block_sparse_moe.experts.{e}.w2.weight"] = (d, f)
    else:
        per_layer.update({
            "mlp.gate_proj.weight": (f, d),
            "mlp.up_proj.weight": (f, d),
            "mlp.down_proj.weight": (d, f),
        })
    for layer in range(cfg.n_layers):
        for suffix, shape in per_layer.items():
            want[f"model.layers.{layer}.{suffix}"] = shape
    problems = []
    for name, shape in want.items():
        if name not in shapes:
            problems.append(f"missing {name}")
        elif tuple(shapes[name]) != shape:
            problems.append(f"{name}: shape {tuple(shapes[name])}, config wants {shape}")
    if "lm_head.weight" in shapes and tuple(shapes["lm_head.weight"]) != (cfg.vocab_size, d):
        problems.append(f"lm_head.weight: shape {tuple(shapes['lm_head.weight'])}, "
                        f"config wants {(cfg.vocab_size, d)}")
    if problems:
        raise ValueError("HF checkpoint mismatch:\n" + "\n".join(problems[:20]))


def llama_hf_key_map(layer: int, moe: bool = False) -> dict[str, str]:
    """The port's per-layer leaf name -> HF tensor name, for ``layer``.
    ``moe=True`` (Mixtral naming) leaves out the dense MLP keys: the router
    and the experts are stacked by ``llama_from_hf_state``."""
    p = f"model.layers.{layer}."
    base = {
        "attn_norm": p + "input_layernorm.weight",
        "wq": p + "self_attn.q_proj.weight",
        "wk": p + "self_attn.k_proj.weight",
        "wv": p + "self_attn.v_proj.weight",
        "wo": p + "self_attn.o_proj.weight",
        "mlp_norm": p + "post_attention_layernorm.weight",
    }
    if not moe:
        base.update({
            "w_gate": p + "mlp.gate_proj.weight",
            "w_up": p + "mlp.up_proj.weight",
            "w_down": p + "mlp.down_proj.weight",
        })
    return base


_TRANSPOSED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}


class _Stacked:
    """An (L, *shape) leaf filled one layer at a time: at ``dtype``, or as
    an int8 ``{"q", "s"}`` leaf quantized per layer as it is written."""

    def __init__(self, L: int, shape: tuple[int, ...], dtype, device, quant: bool):
        self.quant = quant
        if quant:
            self.leaf = {"q": torch.empty((L, *shape), dtype=torch.int8, device=device),
                         "s": torch.empty((L, *shape[:-2], 1, shape[-1]), dtype=torch.float32,
                                          device=device)}
        else:
            self.leaf = torch.empty((L, *shape), dtype=dtype, device=device)

    def put(self, i: int, x: torch.Tensor, expert: int | None = None) -> None:
        at = (i,) if expert is None else (i, expert)
        if self.quant:
            q = quantize_leaf(x)
            self.leaf["q"][at], self.leaf["s"][at] = q["q"], q["s"]
        else:
            self.leaf[at] = x


def llama_from_hf_state(state, cfg: LlamaConfig, dtype=torch.bfloat16, device="cpu",
                        quant: str | None = None) -> dict:
    """An HF Llama / Mixtral state dict (name -> numpy array or tensor), or
    a safetensors directory, -> the port's stacked param tree on ``device``
    at ``dtype``. Every shape is checked against ``cfg``. ``quant="int8"``
    quantizes every matmul weight (dense ``w*``, stacked ``moe_*`` and the
    head) as it is read, one layer at a time; the router, norms and the
    embedding stay at ``dtype``."""
    if quant not in (None, "int8"):
        raise ValueError(f"unknown quant {quant!r}")
    state, owned = _state_reader(state)
    try:
        return _llama_tree(state, cfg, dtype, torch.device(device), quant == "int8")
    finally:
        if owned:
            state.close()


def _llama_tree(state, cfg: LlamaConfig, dtype, device, quant: bool) -> dict:
    get = _Getter(state, device, dtype)
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    nq, nkv, L, E = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers, cfg.n_experts
    moe = E > 0
    want = {
        "attn_norm": (d,),
        "wq": (d, nq * hd),
        "wk": (d, nkv * hd),
        "wv": (d, nkv * hd),
        "wo": (nq * hd, d),
        "mlp_norm": (d,),
    }
    if not moe:
        want.update({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    leaves = {k: _Stacked(L, shape, dtype, device, quant and k in _TRANSPOSED)
              for k, shape in want.items()}
    if moe:
        leaves["router"] = _Stacked(L, (d, E), dtype, device, False)
        for k, shape in (("moe_gate", (E, d, f)), ("moe_up", (E, d, f)),
                         ("moe_down", (E, f, d))):
            leaves[k] = _Stacked(L, shape, dtype, device, quant)
    for layer in range(L):
        for ours, hf_name in llama_hf_key_map(layer, moe=moe).items():
            leaves[ours].put(layer, get(hf_name, want[ours], "lin" if ours in _TRANSPOSED
                                        else ""))
        if moe:
            # Mixtral block_sparse_moe: gate (E, d) -> router (d, E);
            # experts.{e}.w1 / w3 (f, d) -> moe_gate / moe_up (E, d, f);
            # experts.{e}.w2 (d, f) -> moe_down (E, f, d)
            p = f"model.layers.{layer}.block_sparse_moe."
            leaves["router"].put(layer, get(p + "gate.weight", (d, E), "lin"))
            for ours, hf_w, shape in (("moe_gate", "w1", (d, f)), ("moe_up", "w3", (d, f)),
                                      ("moe_down", "w2", (f, d))):
                for e in range(E):
                    leaves[ours].put(layer, get(f"{p}experts.{e}.{hf_w}.weight", shape, "lin"),
                                     expert=e)
    embed = get("model.embed_tokens.weight", (cfg.vocab_size, d))
    if "lm_head.weight" in state:
        lm_head = get("lm_head.weight", (d, cfg.vocab_size), "lin")
    else:  # tied embeddings (TinyLlama-style exports, Llama-3.2-1B)
        lm_head = embed.t().contiguous()
    return {
        "embed": embed,
        "layers": {k: v.leaf for k, v in leaves.items()},
        "final_norm": get("model.norm.weight", (d,)),
        "lm_head": quantize_leaf(lm_head) if quant else lm_head,
    }


def _stack_layers(items: list[dict]) -> dict:
    """Stack per-layer leaf dicts (possibly nested) on a leading layer axis."""
    return {k: (_stack_layers([it[k] for it in items]) if isinstance(v, dict)
                else torch.stack([it[k] for it in items]))
            for k, v in items[0].items()}


# ---------------------------------------------------------------- whisper


def whisper_from_hf_state(state, cfg, dtype=torch.bfloat16, device="cpu") -> dict:
    """An HF Whisper state dict (``WhisperForConditionalGeneration`` naming,
    ``model.encoder/decoder.*``), or a safetensors directory, -> the port's
    Whisper tree on ``device`` at ``dtype``: linear weights (out, in) ->
    (in, out), conv kernels (out, in, k) -> (k, in, out), no k bias."""
    state, owned = _state_reader(state)
    try:
        return _whisper_tree(_Getter(state, torch.device(device), dtype), cfg)
    finally:
        if owned:
            state.close()


def _whisper_tree(get: _Getter, cfg) -> dict:
    d, f = cfg.d_model, cfg.ffn_dim

    def attn(prefix: str) -> dict:
        p = prefix + "."
        return {
            "wq": get(p + "q_proj.weight", (d, d), "lin"),
            "bq": get(p + "q_proj.bias", (d,)),
            "wk": get(p + "k_proj.weight", (d, d), "lin"),
            "wv": get(p + "v_proj.weight", (d, d), "lin"),
            "bv": get(p + "v_proj.bias", (d,)),
            "wo": get(p + "out_proj.weight", (d, d), "lin"),
            "bo": get(p + "out_proj.bias", (d,)),
        }

    def ln(name: str) -> dict:
        return {"g": get(name + ".weight", (d,)), "b": get(name + ".bias", (d,))}

    def mlp(p: str) -> dict:
        return {"w1": get(p + ".fc1.weight", (d, f), "lin"), "b1": get(p + ".fc1.bias", (f,)),
                "w2": get(p + ".fc2.weight", (f, d), "lin"), "b2": get(p + ".fc2.bias", (d,))}

    enc_layers = []
    for n in range(cfg.enc_layers):
        p = f"model.encoder.layers.{n}"
        enc_layers.append({"ln1": ln(p + ".self_attn_layer_norm"),
                           "attn": attn(p + ".self_attn"),
                           "ln2": ln(p + ".final_layer_norm"), **mlp(p)})
    dec_layers = []
    for n in range(cfg.dec_layers):
        p = f"model.decoder.layers.{n}"
        dec_layers.append({"ln1": ln(p + ".self_attn_layer_norm"),
                           "self_attn": attn(p + ".self_attn"),
                           "ln2": ln(p + ".encoder_attn_layer_norm"),
                           "cross_attn": attn(p + ".encoder_attn"),
                           "ln3": ln(p + ".final_layer_norm"), **mlp(p)})
    return {
        "encoder": {
            "conv1": {"w": get("model.encoder.conv1.weight", (3, cfg.n_mels, d), "conv"),
                      "b": get("model.encoder.conv1.bias", (d,))},
            "conv2": {"w": get("model.encoder.conv2.weight", (3, d, d), "conv"),
                      "b": get("model.encoder.conv2.bias", (d,))},
            "layers": _stack_layers(enc_layers),
            "ln_post": ln("model.encoder.layer_norm"),
        },
        "decoder": {
            "tok_emb": get("model.decoder.embed_tokens.weight", (cfg.vocab_size, d)),
            "pos_emb": get("model.decoder.embed_positions.weight", (cfg.max_text_len, d)),
            "layers": _stack_layers(dec_layers),
            "ln_final": ln("model.decoder.layer_norm"),
        },
    }
