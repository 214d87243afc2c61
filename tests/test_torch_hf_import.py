"""The port's HF checkpoint import against the JAX package's.

Fixtures write small HF-layout directories (2 layers, narrow widths) with the
``safetensors`` package, from seeded numpy weights: a dense Llama with tied
embeddings, one with an ``lm_head``, a Mixtral-layout one and a Whisper one.
The port reads the format itself (``ckpt/hf_import.py``); its trees must
equal the JAX package's, moved across with ``bridge``, exactly in F32. The
JAX reader (``safe_open(framework="np")``) cannot read BF16, so BF16 and F16
shards are held against the same weights written as F32.
"""

import json
import struct
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch

from tpu_voice_agent.ckpt import hf_import as jhf
from tpu_voice_agent.models.llama import quantize_params as j_quantize
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.ckpt import hf_import as thf
from tpu_voice_agent_torch.models.llama import PRESETS, quantize_params


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the suite runs in six worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, F, NQ, NKV, L, V, E = 64, 96, 4, 2, 2, 300, 4


def _llama_config(moe: bool = False) -> dict:
    cfg = {"vocab_size": V, "hidden_size": D, "num_hidden_layers": L,
           "num_attention_heads": NQ, "num_key_value_heads": NKV, "intermediate_size": F,
           "max_position_embeddings": 512, "rope_theta": 500000.0, "rms_norm_eps": 1e-6}
    if moe:
        cfg.update(num_local_experts=E, num_experts_per_tok=2)
    return cfg


def llama_state(seed: int, moe: bool = False, head: bool = False) -> dict:
    """HF-named float32 numpy weights: (out, in) layout, as HF stores them."""
    rng = np.random.default_rng(seed)
    hd = D // NQ

    def w(*s):
        return rng.normal(0, 0.05, s).astype(np.float32)

    state = {"model.embed_tokens.weight": w(V, D),
             "model.norm.weight": 1 + w(D)}
    if head:
        state["lm_head.weight"] = w(V, D)
    for i in range(L):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = 1 + w(D)
        state[p + "post_attention_layernorm.weight"] = 1 + w(D)
        state[p + "self_attn.q_proj.weight"] = w(NQ * hd, D)
        state[p + "self_attn.k_proj.weight"] = w(NKV * hd, D)
        state[p + "self_attn.v_proj.weight"] = w(NKV * hd, D)
        state[p + "self_attn.o_proj.weight"] = w(D, NQ * hd)
        if moe:
            state[p + "block_sparse_moe.gate.weight"] = w(E, D)
            for e in range(E):
                q = f"{p}block_sparse_moe.experts.{e}."
                state[q + "w1.weight"] = w(F, D)
                state[q + "w3.weight"] = w(F, D)
                state[q + "w2.weight"] = w(D, F)
        else:
            state[p + "mlp.gate_proj.weight"] = w(F, D)
            state[p + "mlp.up_proj.weight"] = w(F, D)
            state[p + "mlp.down_proj.weight"] = w(D, F)
    return state


def write_shards(d, state: dict, n: int = 1, dtype=None) -> None:
    """``state`` as ``n`` shards of ``model-0000k-of-0000n.safetensors``;
    ``dtype`` (torch) writes through ``safetensors.torch`` in that dtype."""
    names = sorted(state)
    for k in range(n):
        part = {nm: state[nm] for nm in names[k::n]}
        path = str(d / f"model-{k + 1:05d}-of-{n:05d}.safetensors")
        if dtype is None:
            save_file(part, path)
        else:
            save_torch({nm: torch.from_numpy(a).to(dtype) for nm, a in part.items()}, path)


def write_llama_dir(d, seed: int, moe: bool = False, head: bool = False, shards: int = 1,
                    dtype=None) -> dict:
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(_llama_config(moe)))
    state = llama_state(seed, moe, head)
    write_shards(d, state, shards, dtype)
    return state


def _flat(tree) -> dict:
    return bridge.flatten(tree)


def _assert_tree_equal(port: dict, want: dict) -> None:
    a, b = _flat(port), _flat(want)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _jax_tree(tree) -> dict:
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


# ---------------------------------------------------------------- the reader


@pytest.mark.parametrize("dtype,shards", [(None, 1), (None, 3), (torch.float16, 2),
                                          (torch.bfloat16, 2), (torch.bfloat16, 1)])
def test_reader_reads_sharded_files_in_each_dtype(tmp_path, dtype, shards):
    """F32, F16 and BF16, one shard or several: every tensor comes back in
    its file dtype, equal to the same weights written as F32 and cast."""
    state = write_llama_dir(tmp_path, 0, shards=shards, dtype=dtype)
    assert len(list(tmp_path.glob("*.safetensors"))) == shards
    reader = thf.SafetensorsDir(tmp_path)
    got = {k: reader[k].clone() for k in reader.index}
    reader.close()
    assert sorted(got) == sorted(state)
    for k, a in state.items():
        want = torch.from_numpy(a).to(dtype or torch.float32)
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k
    assert thf.safetensors_shapes(tmp_path) == jhf.safetensors_shapes(str(tmp_path)) == {
        k: a.shape for k, a in state.items()}


def test_bf16_and_f16_trees_equal_the_f32_tree_cast(tmp_path):
    """A BF16 directory loads to the F32 directory's tree rounded to bf16
    (the cast the JAX loader applies), an F16 one through f16."""
    write_llama_dir(tmp_path / "f32", 1)
    write_llama_dir(tmp_path / "bf16", 1, shards=2, dtype=torch.bfloat16)
    write_llama_dir(tmp_path / "f16", 1, shards=2, dtype=torch.float16)
    cfg = thf.llama_config_from_hf(tmp_path / "f32")
    f32 = thf.llama_from_hf_state(str(tmp_path / "f32"), cfg, dtype=torch.float32)
    _assert_tree_equal(thf.llama_from_hf_state(str(tmp_path / "bf16"), cfg),
                       {k: v for k, v in _cast(f32, torch.bfloat16).items()})
    f16 = thf.llama_from_hf_state(str(tmp_path / "f16"), cfg, dtype=torch.float32)
    _assert_tree_equal(f16, _cast(_cast(f32, torch.float16), torch.float32))


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


# ---------------------------------------------------------------- error paths


def _header_file(path, header: dict, data: bytes = b"") -> None:
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


def test_a_missing_tensor_is_named(tmp_path):
    state = write_llama_dir(tmp_path / "full", 2)
    del state["model.layers.1.self_attn.v_proj.weight"]
    d = tmp_path / "cut"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(_llama_config()))
    write_shards(d, state)
    cfg = thf.llama_config_from_hf(d)
    with pytest.raises(KeyError, match=r"model\.layers\.1\.self_attn\.v_proj\.weight"):
        thf.llama_from_hf_state(str(d), cfg)
    with pytest.raises(ValueError, match=r"missing model\.layers\.1\.self_attn\.v_proj"):
        thf.llama_hf_check(thf.safetensors_shapes(d), cfg)


def test_a_shape_against_the_config_is_named(tmp_path):
    write_llama_dir(tmp_path, 3)
    cfg = replace(thf.llama_config_from_hf(tmp_path), ffn_dim=F + 2)
    with pytest.raises(ValueError, match=r"model\.layers\.0\.mlp\.gate_proj\.weight: shape "
                                         r"\(64, 96\), config wants \(64, 98\)"):
        thf.llama_from_hf_state(str(tmp_path), cfg)
    with pytest.raises(ValueError, match=r"mlp\.up_proj\.weight: shape \(96, 64\), config "
                                         r"wants \(98, 64\)"):
        thf.llama_hf_check(thf.safetensors_shapes(tmp_path), cfg)


def test_an_unread_dtype_is_named(tmp_path):
    _header_file(tmp_path / "model.safetensors",
                 {"model.norm.weight": {"dtype": "I64", "shape": [2], "data_offsets": [0, 16]}},
                 bytes(16))
    r = thf.SafetensorsDir(tmp_path)
    with pytest.raises(ValueError, match="model.norm.weight: dtype I64 is not read"):
        r["model.norm.weight"]


@pytest.mark.parametrize("case", ["two_shards", "short_data", "offsets_past_end",
                                  "no_header", "not_json"])
def test_a_malformed_file_is_named(tmp_path, case):
    f = tmp_path / "model-a.safetensors"
    meta = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    if case == "two_shards":
        _header_file(f, {"x": meta}, bytes(8))
        _header_file(tmp_path / "model-b.safetensors", {"x": meta}, bytes(8))
        match = "tensor x is in two shards"
    elif case == "short_data":
        _header_file(f, {"x": {**meta, "shape": [3]}}, bytes(8))
        match = r"x: 8 data bytes for shape \(3,\)"
    elif case == "offsets_past_end":
        _header_file(f, {"x": {**meta, "data_offsets": [0, 64]}}, bytes(8))
        match = r"x: data_offsets \[0, 64\] outside"
    elif case == "no_header":
        f.write_bytes(b"\x01\x02")
        match = "not a safetensors file"
    else:
        f.write_bytes(struct.pack("<Q", 5) + b"{oops")
        match = "header is not JSON"
    with pytest.raises(ValueError, match=match):
        thf.SafetensorsDir(tmp_path)["x"]


def test_a_directory_without_shards_is_named(tmp_path):
    with pytest.raises(FileNotFoundError, match=f"no \\*.safetensors under {tmp_path}"):
        thf.safetensors_shapes(tmp_path)
    with pytest.raises(FileNotFoundError, match="no config.json"):
        thf.llama_config_from_hf(tmp_path)


@pytest.mark.parametrize("missing,match", [
    ("dir", "no such directory"), ("config.json", "no config.json"),
    ("tokenizer.json", "no tokenizer.json"), ("shards", r"no \*\.safetensors"),
])
def test_check_hf_dir_names_the_knob_and_the_path(tmp_path, missing, match):
    d = tmp_path / "ckpt"
    if missing != "dir":
        write_llama_dir(d, 4)
        (d / "tokenizer.json").write_text("{}")
        if missing == "shards":
            for f in d.glob("*.safetensors"):
                f.unlink()
        else:
            (d / missing).unlink()
    with pytest.raises(ValueError, match=f"BRAIN_MODEL={str(d)!r}: {match}"):
        thf.check_hf_dir(d, "BRAIN_MODEL")


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("moe", [False, True])
def test_llama_config_equals_jax(tmp_path, moe):
    from tpu_voice_agent.models.llama import LlamaConfig as JConfig

    (tmp_path / "config.json").write_text(json.dumps(_llama_config(moe)))
    port, jx = thf.llama_config_from_hf(tmp_path), jhf.llama_config_from_hf(str(tmp_path))
    assert isinstance(jx, JConfig)
    assert asdict(port) == {k: v for k, v in asdict(jx).items() if k in asdict(port)}
    assert (port.n_experts, port.capacity_factor) == ((E, 2.0) if moe else (0, 1.25))
    assert (port.rope_theta, port.norm_eps) == (500000.0, 1e-6)


def test_whisper_config_equals_jax(tmp_path):
    cfg = {"vocab_size": 51866, "d_model": 1280, "encoder_attention_heads": 20,
           "decoder_attention_heads": 20, "encoder_layers": 32, "decoder_layers": 32,
           "num_mel_bins": 128, "max_source_positions": 1500, "max_target_positions": 448}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    port, jx = thf.whisper_config_from_hf(tmp_path), jhf.whisper_config_from_hf(str(tmp_path))
    assert asdict(port) == {k: v for k, v in asdict(jx).items() if k in asdict(port)}
    assert (port.n_mels, port.enc_positions, port.head_dim) == (128, 1500, 64)


def test_tinyllama_shape_check_without_data():
    """The header check covers TinyLlama-1.1B's published layout (vocab
    32,000, GQA 32/4) without a byte of data; one bad shape is named."""
    cfg = replace(PRESETS["tinyllama-1.1b"], vocab_size=32000)
    d, f, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    shapes = {"model.embed_tokens.weight": (32000, d), "model.norm.weight": (d,),
              "lm_head.weight": (32000, d)}
    for layer in range(cfg.n_layers):
        p = f"model.layers.{layer}."
        shapes.update({p + "input_layernorm.weight": (d,),
                       p + "post_attention_layernorm.weight": (d,),
                       p + "self_attn.q_proj.weight": (cfg.n_heads * hd, d),
                       p + "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, d),
                       p + "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, d),
                       p + "self_attn.o_proj.weight": (d, cfg.n_heads * hd),
                       p + "mlp.gate_proj.weight": (f, d), p + "mlp.up_proj.weight": (f, d),
                       p + "mlp.down_proj.weight": (d, f)})
    thf.llama_hf_check(shapes, cfg)
    shapes["model.layers.3.mlp.up_proj.weight"] = (f, d + 1)
    with pytest.raises(ValueError, match="mlp.up_proj"):
        thf.llama_hf_check(shapes, cfg)


def test_key_map_equals_jax():
    for layer, moe in ((0, False), (5, True)):
        assert thf.llama_hf_key_map(layer, moe) == jhf.llama_hf_key_map(layer, moe)


# ---------------------------------------------------------------- trees


@pytest.mark.parametrize("moe,head,from_dir", [(False, False, True), (False, True, True),
                                               (True, False, True), (True, True, False)])
def test_llama_tree_equals_jax_exactly_in_f32(tmp_path, moe, head, from_dir):
    """Dense with tied embeddings (no ``lm_head.weight``: ``embed.T``), dense
    with a head, Mixtral stacking (router / moe_gate / moe_up / moe_down),
    from a directory or a state dict: the JAX tree, bridged, bit for bit."""
    state = write_llama_dir(tmp_path, 5, moe=moe, head=head, shards=2)
    cfg = thf.llama_config_from_hf(tmp_path)
    src = str(tmp_path) if from_dir else state
    port = thf.llama_from_hf_state(src, cfg, dtype=torch.float32)
    want = _jax_tree(jhf.llama_from_hf_state(str(tmp_path) if from_dir else state,
                                             jhf.llama_config_from_hf(str(tmp_path)),
                                             dtype=jnp.float32))
    _assert_tree_equal(port, want)
    if moe:
        assert port["layers"]["moe_gate"].shape == (L, E, D, F)
        assert port["layers"]["router"].shape == (L, D, E)
    if not head:
        assert torch.equal(port["lm_head"], port["embed"].t())


@pytest.mark.parametrize("moe", [False, True])
def test_int8_per_layer_equals_quantize_params(tmp_path, moe):
    """Quantized as read, one layer at a time, equals ``quantize_params``
    on the whole bf16 tree, and the JAX package's ``quantize_params``."""
    write_llama_dir(tmp_path, 6, moe=moe)
    cfg = thf.llama_config_from_hf(tmp_path)
    whole = quantize_params(thf.llama_from_hf_state(str(tmp_path), cfg))
    per_layer = thf.llama_from_hf_state(str(tmp_path), cfg, quant="int8")
    _assert_tree_equal(per_layer, whole)
    jq = j_quantize(jhf.llama_from_hf_state(str(tmp_path), jhf.llama_config_from_hf(
        str(tmp_path)), dtype=jnp.bfloat16))
    _assert_tree_equal(per_layer, _jax_tree(jq))
    assert per_layer["layers"]["wq"]["q"].dtype == torch.int8
    if moe:
        assert not isinstance(per_layer["layers"]["router"], dict)
        assert per_layer["layers"]["moe_down"]["s"].shape == (L, E, 1, D)


def whisper_state(seed: int, V_: int = 120, D_: int = 64, F_: int = 256, n_mels: int = 80,
                  text_len: int = 64) -> dict:
    rng = np.random.default_rng(seed)

    def w(*s):
        return rng.normal(0, 0.05, s).astype(np.float32)

    state = {"model.encoder.conv1.weight": w(D_, n_mels, 3), "model.encoder.conv1.bias": w(D_),
             "model.encoder.conv2.weight": w(D_, D_, 3), "model.encoder.conv2.bias": w(D_),
             "model.encoder.layer_norm.weight": 1 + w(D_),
             "model.encoder.layer_norm.bias": w(D_),
             "model.decoder.embed_tokens.weight": w(V_, D_),
             "model.decoder.embed_positions.weight": w(text_len, D_),
             "model.decoder.layer_norm.weight": 1 + w(D_),
             "model.decoder.layer_norm.bias": w(D_),
             # HF's tied output projection: not read (logits use the embedding)
             "proj_out.weight": w(V_, D_)}

    def attn(p):
        for k in ("q", "v", "out"):
            state[f"{p}.{k}_proj.weight"] = w(D_, D_)
            state[f"{p}.{k}_proj.bias"] = w(D_)
        state[f"{p}.k_proj.weight"] = w(D_, D_)

    def block(p, lns):
        for ln in lns:
            state[p + ln + ".weight"] = 1 + w(D_)
            state[p + ln + ".bias"] = w(D_)
        state[p + ".fc1.weight"], state[p + ".fc1.bias"] = w(F_, D_), w(F_)
        state[p + ".fc2.weight"], state[p + ".fc2.bias"] = w(D_, F_), w(D_)

    for n in range(2):
        p = f"model.encoder.layers.{n}"
        attn(p + ".self_attn")
        block(p, (".self_attn_layer_norm", ".final_layer_norm"))
        p = f"model.decoder.layers.{n}"
        attn(p + ".self_attn")
        attn(p + ".encoder_attn")
        block(p, (".self_attn_layer_norm", ".encoder_attn_layer_norm", ".final_layer_norm"))
    return state


WHISPER_CONFIG = {"vocab_size": 120, "d_model": 64, "encoder_attention_heads": 4,
                  "decoder_attention_heads": 4, "encoder_layers": 2, "decoder_layers": 2,
                  "encoder_ffn_dim": 256, "decoder_ffn_dim": 256, "num_mel_bins": 80,
                  "max_source_positions": 100, "max_target_positions": 64}


@pytest.mark.parametrize("shards", [1, 2])
def test_whisper_tree_equals_jax_exactly_in_f32(tmp_path, shards):
    (tmp_path / "config.json").write_text(json.dumps(WHISPER_CONFIG))
    write_shards(tmp_path, whisper_state(7), shards)
    cfg = thf.whisper_config_from_hf(tmp_path)
    port = thf.whisper_from_hf_state(str(tmp_path), cfg, dtype=torch.float32)
    want = _jax_tree(jhf.whisper_from_hf_state(str(tmp_path), jhf.whisper_config_from_hf(
        str(tmp_path)), dtype=jnp.float32))
    _assert_tree_equal(port, want)
    assert port["encoder"]["conv1"]["w"].shape == (3, 80, 64)
    assert "bk" not in port["encoder"]["layers"]["attn"]


def test_whisper_bf16_tree_equals_the_f32_tree_cast(tmp_path):
    (tmp_path / "f32").mkdir()
    (tmp_path / "bf16").mkdir()
    state = whisper_state(8)
    for d, dt in ((tmp_path / "f32", None), (tmp_path / "bf16", torch.bfloat16)):
        (d / "config.json").write_text(json.dumps(WHISPER_CONFIG))
        write_shards(d, state, 2, dt)
    cfg = thf.whisper_config_from_hf(tmp_path / "f32")
    f32 = thf.whisper_from_hf_state(str(tmp_path / "f32"), cfg, dtype=torch.float32)
    _assert_tree_equal(thf.whisper_from_hf_state(str(tmp_path / "bf16"), cfg),
                       _cast(f32, torch.bfloat16))


def test_whisper_missing_tensor_and_shape_are_named(tmp_path):
    state = whisper_state(9)
    write_shards(tmp_path, state)
    (tmp_path / "config.json").write_text(json.dumps(WHISPER_CONFIG))
    cfg = thf.whisper_config_from_hf(tmp_path)
    cut = {k: v for k, v in state.items()
           if k != "model.decoder.layers.1.encoder_attn.out_proj.bias"}
    with pytest.raises(KeyError, match=r"decoder\.layers\.1\.encoder_attn\.out_proj\.bias"):
        thf.whisper_from_hf_state(cut, cfg)
    with pytest.raises(ValueError, match=r"model\.encoder\.conv1\.weight: shape \(3, 80, 64\), "
                                         r"config wants \(3, 128, 64\)"):
        thf.whisper_from_hf_state(str(tmp_path), replace(cfg, n_mels=128))
