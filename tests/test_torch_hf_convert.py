"""Released weights into the port on the CPU: each converter of
``videotgb_torch.training.hf_convert`` gives the JAX converter's flat dict
exactly on the same tiny HF state dicts (``Blip2ForConditionalGeneration``,
InstructBLIP with a T5 and with a LLaMA language model, ``BertModel``, all
built from config; for RAFT and the reference TGB, whose torch modules
live only in the reference, state dicts made by inverting the JAX
converter on a seeded tree); the ``convert_checkpoint`` CLI's checkpoint,
restored by the port's ``load_model``, gives the HF vision, Q-Former, T5
and LLaMA outputs within 2e-4; a JAX ``scan_layers`` tree carries across
unstacked."""

import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import _torch_reference_names as RN
from _torch_port_helpers import (  # noqa: F401
    f32_tiny_presets,
    few_torch_threads,
    jax_params,
)
from _torch_port_helpers import cheap_jax_compiles  # noqa: F401
from videotgb_torch.convert import (
    flat_to_state_dict,
    flax_to_state_dict,
    load_flax_params,
)
from videotgb_torch.evalsuite.inference import load_model
from videotgb_torch.models import videotgb as TV
from videotgb_torch.tools import convert_checkpoint as TCC
from videotgb_torch.training import hf_convert as TC
from videotgb_tpu.models import videotgb as JV
from videotgb_tpu.training import convert as JC

VISION = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=4, image_size=56, patch_size=14,
              hidden_act="gelu", layer_norm_eps=1e-6)
QFORMER = dict(vocab_size=384, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64,
               hidden_act="gelu", encoder_hidden_size=64,
               cross_attention_frequency=2, attention_probs_dropout_prob=0.0,
               hidden_dropout_prob=0.0, max_position_embeddings=512)
T5 = dict(model_type="t5", vocab_size=384, d_model=32, d_kv=8, num_heads=4,
          d_ff=64, num_layers=2, num_decoder_layers=2,
          feed_forward_proj="gated-gelu", tie_word_embeddings=False,
          dropout_rate=0.0)
LLAMA = dict(model_type="llama", vocab_size=384, hidden_size=32,
             intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=4, rms_norm_eps=1e-6, attention_bias=False,
             rope_theta=10000.0, attention_dropout=0.0,
             tie_word_embeddings=False)


def _hf(kind):
    """A tiny HF model of ``kind`` (blip2, instructblip_t5, instructblip)
    built from config with weights from a seed, in eval mode."""
    import transformers as T

    torch.manual_seed(0)
    if kind == "blip2":
        cfg = T.Blip2Config(vision_config=VISION, qformer_config=QFORMER,
                            text_config=T5, num_query_tokens=8)
        model = T.Blip2ForConditionalGeneration(cfg)
    else:
        cfg = T.InstructBlipConfig(
            vision_config=VISION, qformer_config=QFORMER,
            text_config=T5 if kind == "instructblip_t5" else LLAMA,
            num_query_tokens=8)
        model = T.InstructBlipForConditionalGeneration(cfg)
    return model.eval()


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _equal(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))


@pytest.fixture(scope="module")
def hf_models():
    return {kind: _hf(kind)
            for kind in ("blip2", "instructblip_t5", "instructblip")}


# ----------------------------------------------------- converter for converter
@pytest.mark.parametrize("kind", ["blip2", "instructblip_t5", "instructblip"])
def test_backbone_converters_match_jax(hf_models, kind):
    sd = _sd(hf_models[kind])
    instruct = kind != "blip2"
    _equal(TC.convert_blip2_vision(sd, 2, "vision_model."),
           JC.convert_blip2_vision(sd, 2, "vision_model."))
    _equal(TC.convert_blip2_qformer(sd, 2, 2, "qformer.", instruct=instruct),
           JC.convert_blip2_qformer(sd, 2, 2, "qformer.", instruct=instruct))
    if kind == "instructblip":
        _equal(TC.convert_llama(sd, 2, "language_model."),
               JC.convert_llama(sd, 2, "language_model."))
    else:
        _equal(TC.convert_t5(sd, 2, 2, "language_model."),
               JC.convert_t5(sd, 2, 2, "language_model."))


def test_bert_converter_matches_jax():
    import transformers as T

    torch.manual_seed(1)
    bert = T.BertModel(T.BertConfig(
        vocab_size=384, hidden_size=32, num_hidden_layers=4,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=128)).eval()
    sd = _sd(bert)
    _equal(TC.convert_bert_to_tgb(sd, 4), JC.convert_bert_to_tgb(sd, 4))
    prefixed = {f"bert.{k}": v for k, v in sd.items()}
    _equal(TC.convert_bert_to_tgb(prefixed, 4, "bert."),
           JC.convert_bert_to_tgb(prefixed, 4, "bert."))


# torch names of the reference's RAFT and RopeBertModel for the flax paths
# that the JAX converters write: (flax path regex, torch name template)
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_TGB_RULES = [
    (r"word_embeddings", "embeddings.word_embeddings"),
    (r"token_type_embeddings", "embeddings.token_type_embeddings"),
    (r"text_ln", "embeddings.LayerNorm"),
    (r"layer_(\d+)/(self|cross)_attn/([qkv])", None),
    (r"layer_(\d+)/self_attn/o", r"encoder.layer.\1.attention.output.dense"),
    (r"layer_(\d+)/self_ln", r"encoder.layer.\1.attention.output.LayerNorm"),
    (r"layer_(\d+)/cross_attn/o",
     r"encoder.layer.\1.crossattention.output.dense"),
    (r"layer_(\d+)/cross_ln",
     r"encoder.layer.\1.crossattention.output.LayerNorm"),
    (r"layer_(\d+)/mlp/wi", r"encoder.layer.\1.intermediate.dense"),
    (r"layer_(\d+)/mlp/wo", r"encoder.layer.\1.output.dense"),
    (r"layer_(\d+)/ffn_ln", r"encoder.layer.\1.output.LayerNorm"),
    (r"temporal_embeddings/(projection|fc|frame_pos_embed|ln)",
     r"temporal_embeddings.\1"),
    (r"mrc_head", "mrc_head"),
]
_QKV = {"q": "query", "k": "key", "v": "value"}


def _torch_value(leaf, value):
    if leaf == "kernel":
        return value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    return value


def _tgb_state_dict(tree):
    """A RopeBertModel state dict for the seeded TGB ``tree``."""
    out = {}
    for path, value in flatten_dict(tree).items():
        scope, leaf = "/".join(path[:-1]), path[-1]
        if path in (("temporal_embeddings", "bos"),
                    ("temporal_embeddings", "eos")):
            out[f"temporal_embeddings.{leaf}"] = value
            continue
        for pattern, name in _TGB_RULES:
            m = re.fullmatch(pattern, scope)
            if m is None:
                continue
            if name is None:  # q / k / v of either attention
                sub = "attention" if m.group(2) == "self" else \
                    "crossattention"
                name = (f"encoder.layer.{m.group(1)}.{sub}.self."
                        f"{_QKV[m.group(3)]}")
            else:
                name = m.expand(name)
            torch_leaf = "bias" if leaf == "bias" else "weight"
            out[f"{name}.{torch_leaf}"] = _torch_value(leaf, value)
    return out


def _raft_state_dict(tree):
    """A raft-sintel.pth state dict for the seeded RAFT ``tree``."""
    out = {}
    for path, value in flatten_dict(tree).items():
        scope, leaf = ".".join(path[:-1]), path[-1]
        scope = re.sub(r"layer(\d)_(\d)", r"layer\1.\2", scope)
        scope = scope.replace("downsample", "downsample.0")
        scope = scope.replace("norm3.norm", "downsample.1")
        scope = re.sub(r"(norm\d)\.norm", r"\1", scope)
        scope = scope.replace("flow_head_conv", "flow_head.conv")
        scope = scope.replace("mask_conv1", "mask.0").replace(
            "mask_conv2", "mask.2")
        if leaf in _BN and "norm" in path[-2]:
            out[f"{scope}.{_BN[leaf]}"] = value
        else:
            torch_leaf = "bias" if leaf == "bias" else "weight"
            out[f"{scope}.{torch_leaf}"] = _torch_value(leaf, value)
    return out


@pytest.fixture(scope="module")
def seeded_tree():
    cfg = JV.VideoTGBConfig.tiny()
    return jax.tree.map(np.asarray,
                        jax_params(JV.VideoTGB(cfg), cfg, seed=2)["params"])


def test_raft_and_reference_tgb_converters_match_jax(seeded_tree):
    raft_sd = _raft_state_dict(seeded_tree["of_extractor"])
    want = JC.convert_raft(raft_sd)
    # the inverse is the JAX converter's: every RAFT leaf comes back
    assert want.keys() == flatten_dict(seeded_tree["of_extractor"]).keys()
    _equal(TC.convert_raft(raft_sd), want)
    _equal(TC.convert_raft(raft_sd), {
        k: v for k, v in flatten_dict(seeded_tree["of_extractor"]).items()})

    cfg = JV.VideoTGBConfig.tiny().tgb
    tgb_sd = _tgb_state_dict(seeded_tree["temporal_encoder"])
    want = JC.convert_reference_tgb(tgb_sd, cfg.num_layers, cfg.fusion_layer)
    flat = flatten_dict(seeded_tree["temporal_encoder"])
    assert all(np.array_equal(v, flat[k]) for k, v in want.items())
    _equal(TC.convert_reference_tgb(tgb_sd, cfg.num_layers,
                                    cfg.fusion_layer), want)
    assert TC.with_subtree({("a",): 1}, "x", "y") == \
        JC.with_subtree({("a",): 1}, "x", "y")


# ---------------------------------------------------------------- the CLI
def _write_sources(root, hf, seeded_tree, save):
    """The released files: the HF backbone dir, a sampler.pth and a
    raft-sintel.pth (with DataParallel prefixes), by ``save``."""
    backbone = root / "backbone"
    hf.save_pretrained(str(backbone), safe_serialization=save == "safetensors")
    tensors = lambda sd: {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}
    raft = tensors(_raft_state_dict(seeded_tree["of_extractor"]))
    torch.save({f"module.{k}": v for k, v in raft.items()},
               root / "raft-sintel.pth")
    torch.save(tensors(_tgb_state_dict(seeded_tree["temporal_encoder"])),
               root / "sampler.pth")
    return backbone


@pytest.mark.parametrize("kind, save", [
    ("blip2", "safetensors"), ("instructblip_t5", "bin"),
    ("instructblip", "safetensors")])
def test_cli_checkpoint_serves_the_hf_outputs(hf_models, seeded_tree,
                                              tmp_path, monkeypatch, kind,
                                              save):
    f32_tiny_presets(monkeypatch)
    hf = hf_models[kind]
    backbone = _write_sources(tmp_path, hf, seeded_tree, save)
    out = TCC.main(["--preset", "tiny", "--backbone", kind,
                    "--backbone_dir", str(backbone),
                    "--sampler_path", str(tmp_path / "sampler.pth"),
                    "--raft_path", str(tmp_path / "raft-sintel.pth"),
                    "--output", str(tmp_path / "converted")])
    model, cfg = load_model(SimpleNamespace(
        model_path=out, preset="tiny", backbone=kind, bf16_params=0),
        device="cpu")
    got = model.state_dict()
    # RAFT whole, and the TGB leaves that sampler.pth carries, as seeded
    for key, value in flax_to_state_dict(
            {"of_extractor": seeded_tree["of_extractor"]}).items():
        assert torch.equal(got[key], value), key
    sampler = flat_to_state_dict(TC.with_subtree(TC.convert_reference_tgb(
        _tgb_state_dict(seeded_tree["temporal_encoder"]),
        cfg.tgb.num_layers, cfg.tgb.fusion_layer), "temporal_encoder"))
    assert len(sampler) > 40
    for key, value in sampler.items():
        assert torch.equal(got[key], value), key

    tol = dict(atol=2e-4, rtol=2e-4)
    rng = np.random.default_rng(7)
    tower = model.model
    pixels = rng.standard_normal((2, 3, 56, 56)).astype(np.float32)
    with torch.no_grad():
        want = hf.vision_model(torch.from_numpy(pixels)).last_hidden_state
        vis = tower.vision_model(torch.from_numpy(pixels.transpose(0, 2, 3,
                                                                   1)))
    np.testing.assert_allclose(vis.numpy(), want.numpy(), **tol)

    q = rng.standard_normal((2, 8, 32)).astype(np.float32)
    img = rng.standard_normal((2, 9, 64)).astype(np.float32)
    with torch.no_grad():
        if kind == "blip2":
            want = hf.qformer(query_embeds=torch.from_numpy(q),
                              encoder_hidden_states=torch.from_numpy(img))
            got_q = tower.qformer(torch.from_numpy(q), torch.from_numpy(img))
        else:
            ids = torch.from_numpy(rng.integers(1, 60, (2, 5)))
            want = hf.qformer(
                input_ids=ids, attention_mask=torch.ones((2, 13)),
                query_embeds=torch.from_numpy(q),
                encoder_hidden_states=torch.from_numpy(img))
            got_q = tower.qformer(torch.from_numpy(q), torch.from_numpy(img),
                                  input_ids=ids,
                                  attention_mask=torch.ones((2, 5)))
    np.testing.assert_allclose(got_q.numpy(),
                               want.last_hidden_state[:, :8].numpy(), **tol)

    lm = tower.language_model
    with torch.no_grad():
        if kind == "instructblip":
            ids = torch.from_numpy(rng.integers(2, 60, (2, 6)))
            want = hf.language_model(input_ids=ids).logits
            got_lm, _ = lm(input_ids=ids)
        else:
            enc = torch.from_numpy(rng.integers(2, 60, (2, 7)))
            dec = torch.from_numpy(rng.integers(2, 60, (2, 5)))
            want = hf.language_model(input_ids=enc,
                                     decoder_input_ids=dec).logits
            got_lm = lm(lm.embed(enc), torch.ones((2, 7)), dec)
    np.testing.assert_allclose(got_lm.numpy(), want.numpy(), **tol)
    np.testing.assert_array_equal(
        tower.query_tokens.detach().numpy(), _sd(hf)["query_tokens"])


# ------------------------------------------------------------ stacked trees
def _stacked(tree, backbone):
    """The JAX package's ``stack_layers`` on the seeded per-layer tree: the
    layout of a ``scan_layers`` model."""
    flat = flatten_dict(tree)
    towers = {("model", "vision_model"): [("layer_", ("layers", "layer"))]}
    if backbone == "blip2":
        towers[("model", "language_model")] = [
            ("encoder_", ("encoder_layers", "block")),
            ("decoder_", ("decoder_layers", "block"))]
    else:
        towers[("model", "language_model")] = [("layer_", ("layers",
                                                           "layer"))]
    out = dict(flat)
    for root, rules in towers.items():
        sub = {k[len(root):]: v for k, v in out.items() if k[:2] == root}
        for k in list(out):
            if k[:2] == root:
                del out[k]
        for prefix, stacked_root in rules:
            sub = JC.stack_layers(sub, prefix, stacked_root)
        out.update({root + k: v for k, v in sub.items()})
    return unflatten_dict(out)


@pytest.mark.parametrize("backbone", ["blip2", "instructblip"])
def test_stacked_tree_carries_across(backbone):
    import dataclasses

    cfg = JV.VideoTGBConfig.tiny(backbone)
    tree = jax.tree.map(np.asarray,
                        jax_params(JV.VideoTGB(cfg), cfg, seed=3)["params"])
    stacked = _stacked(tree, backbone)
    # the layout is a scan_layers model's own
    if backbone == "blip2":
        b2 = cfg.blip2
        scan = dataclasses.replace(cfg, blip2=dataclasses.replace(
            b2, vit=dataclasses.replace(b2.vit, scan_layers=True),
            t5=dataclasses.replace(b2.t5, scan_layers=True)))
    else:
        ib = cfg.instructblip
        scan = dataclasses.replace(cfg, instructblip=dataclasses.replace(
            ib, vit=dataclasses.replace(ib.vit, scan_layers=True),
            llm=dataclasses.replace(ib.llm, scan_layers=True)))
    shapes = jax_params(JV.VideoTGB(scan), scan, seed=3)["params"]
    assert {k: np.shape(v) for k, v in flatten_dict(stacked).items()} == {
        k: np.shape(v) for k, v in flatten_dict(shapes).items()}
    assert any("layers" in k for k in flatten_dict(stacked))

    want = flax_to_state_dict(tree)
    got = flax_to_state_dict(stacked)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    # every parameter of the port's model covered, every leaf housed
    load_flax_params(TV.VideoTGB(TV.VideoTGBConfig.tiny(backbone),
                                 device="cpu"), stacked)


def test_reference_exports_invert_the_converters(seeded_tree):
    """``raft_to_reference`` / ``tgb_to_reference`` on the port's state dict
    give the reference's names and values (those that invert the JAX
    converters above), and converting them back gives the parameters."""
    cfg = JV.VideoTGBConfig.tiny().tgb
    sd = flax_to_state_dict(seeded_tree)
    for export, invert in ((RN.raft_to_reference, lambda: _raft_state_dict(
            seeded_tree["of_extractor"])), (RN.tgb_to_reference, lambda: (
                _tgb_state_dict(seeded_tree["temporal_encoder"])))):
        got, want = export(sd), invert()
        assert got.keys() == want.keys()
        for key, value in want.items():
            np.testing.assert_array_equal(got[key].numpy(), value,
                                          err_msg=key)
    back = flat_to_state_dict({
        **TC.with_subtree(TC.convert_raft(
            {k: v.numpy() for k, v in RN.raft_to_reference(sd).items()}),
            "of_extractor"),
        **TC.with_subtree(TC.convert_reference_tgb(
            {k: v.numpy() for k, v in RN.tgb_to_reference(sd).items()},
            cfg.num_layers, cfg.fusion_layer), "temporal_encoder")})
    own = {k: v for k, v in sd.items()
           if k.startswith(("of_extractor.", "temporal_encoder."))}
    assert back.keys() == own.keys()
    assert all(torch.equal(back[k], v) for k, v in own.items())
