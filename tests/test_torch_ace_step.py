"""The torch port's ACE-Step family against the JAX package, on the CPU.

The Qwen2 rope tables (bitwise) and their application, the Lite-LA linear
attention (masked and not), the ESPnet relative-position table (bitwise),
its shift, a conformer layer and the lyric encoder, one block (the
cross-attention through the op against the JAX dense masked softmax, with
padded lyrics and text, and a latent mask whose rows see no key), the whole
DiT and its LoRA gradients against ``jax.grad`` (with lyrics and masks, with
remat, at a mel height of 2 through the family's reshape) and in bf16; the
lyric ids on a seeded BPE ``vocab.json`` (``tokenizers``) and the CJK
refusal; the diffusers-layout import of a seeded file (trees bitwise); the
key map; the family contract (the LoRA presets, the sidecar lyrics, the
intermediates tap refused by name, the mel reshape refused where the JAX
reshape raises); two ``Trainer.run()`` steps on stereo-free tiny WAVs with
lyrics against the JAX ``Trainer`` on one latent cache; and a true-CFG
render with ``validation_lyrics`` through each package's ``Validation``,
decoded by the tiny audio VAE into a WAV.  The same seeded numpy weights,
inputs and noise go through both packages.  Forwards are held within 1e-5
relative L2 (``F32_REL``), gradient-derived numbers within 1e-4
(``GRAD_REL``, test_torch_sdxl.py's reason), bf16 within 2e-2.  The
kernels at ACE-Step's shapes are held on the card
(test_torch_kernels_cuda.py, chip_smoke.py phases 3, 7 and 47).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.ace_step import transformer as jt
from simpletuner_tpu.models.ace_step.lyrics import LyricsTokenizer as JaxLyricsTokenizer
from simpletuner_tpu.models.ace_step.model import ACEStep as JaxACEStep
from simpletuner_tpu.models.audio_vae import AudioAutoencoderKL as JaxAudioVAE
from simpletuner_tpu.models.audio_vae import AudioVAEConfig as JaxAudioVAEConfig
from simpletuner_tpu.models.weight_import import load_acestep_params as jax_load_acestep_params
from simpletuner_tpu.training.lora import acestep_key_map as jax_acestep_key_map
from simpletuner_tpu.training.validation import Validation as JaxValidation

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models import layers as tl
from simpletuner_tpu_torch.models.ace_step import ACEStep, ACEStepConfig, ACEStepTransformer
from simpletuner_tpu_torch.models.ace_step import transformer as pt
from simpletuner_tpu_torch.models.ace_step.lyrics import LyricsTokenizer
from simpletuner_tpu_torch.models.audio_vae import AudioAutoencoderKL, AudioVAEConfig
from simpletuner_tpu_torch.models.checkpoint_layouts import acestep_checkpoint_shapes
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import (
    load_acestep_params, load_safetensors_file, load_transformer_params, save_safetensors,
)
from simpletuner_tpu_torch.training.lora import acestep_key_map, save_lora_safetensors
from simpletuner_tpu_torch.training.validation import Validation, noise_generator

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, fill_numpy, numpy_variables, rel, t

F32_REL = 1e-5
GRAD_REL = 1e-4
BF16_REL = 2e-2
LYRICS = "[verse]\nWalking in the rain tonight\n\nthe city hums, the lights are bright!\n[chorus]\nhold on"


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target predicate."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def write_lyrics_vocab(path, first_id=270):
    """A seeded BPE tokenizer file in the ``tokenizers`` JSON format, as
    ACE-Step's ``lyrics_utils/vocab.json`` is: single characters and a few
    merges from ``first_id`` on (placeholders below it), the language tags
    and ``[SPACE]`` as special tokens."""
    from tokenizers import Tokenizer, models

    chars = list("abcdefghijklmnopqrstuvwxyz0123456789'.,!?-()[]")
    merges = [("t", "h"), ("th", "e"), ("i", "n"), ("in", "g"), ("e", "r"), ("o", "n"), ("a", "n")]
    vocab = {f"<unused{i}>": i for i in range(first_id)}  # ids below first_id: never produced
    for piece in chars + [a + b for a, b in merges]:
        vocab[piece] = len(vocab)
    tokenizer = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    tokenizer.add_special_tokens(["[SPACE]", "[en]", "[zh]", "[ja]", "[ko]"])
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    tokenizer.save(str(path))
    return str(path)


# the tiny presets as shipped (``_wide_lyrics`` patches the classmethods in some tests)
_PRESETS = (ACEStepConfig.tiny(), jt.ACEStepConfig.tiny())


def _tiny(**fields):
    return dataclasses.replace(_PRESETS[0], **fields), dataclasses.replace(_PRESETS[1], **fields)


def _inputs(arch, batch=2, tokens=12, text=5, lyric=7, seed=0):
    rng = np.random.default_rng(seed)
    latents = rng.standard_normal((batch, arch.latent_height, tokens, arch.in_channels)).astype(np.float32)
    timesteps = np.asarray([0.13, 0.81][:batch], np.float32)
    text_embeds = rng.standard_normal((batch, text, arch.text_dim)).astype(np.float32)
    speaker = rng.standard_normal((batch, arch.speaker_dim)).astype(np.float32)
    ids = rng.integers(0, arch.lyric_vocab, (batch, lyric)).astype(np.int32)
    lyric_mask = np.ones((batch, lyric), np.float32)
    lyric_mask[-1, 4:] = 0
    text_mask = np.ones((batch, text), np.float32)
    text_mask[0, 3:] = 0
    return latents, timesteps, text_embeds, speaker, ids, lyric_mask, text_mask


# ---- the pieces ---------------------------------------------------------------------------------


def test_presets_match_jax():
    for name in ("__call__", "tiny"):
        ours = ACEStepConfig() if name == "__call__" else ACEStepConfig.tiny()
        theirs = jt.ACEStepConfig() if name == "__call__" else jt.ACEStepConfig.tiny()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
    cfg = ACEStepConfig()
    assert (cfg.inner_dim, cfg.num_heads, cfg.head_dim, int(cfg.inner_dim * cfg.mlp_ratio), cfg.lyric_hidden,
            cfg.lyric_depth, cfg.lyric_vocab) == (1536, 24, 64, 6144, 1024, 6, 6681)
    for name in ("ace", "tiny"):
        assert dataclasses.asdict(getattr(AudioVAEConfig, name)()) == \
            dataclasses.asdict(getattr(JaxAudioVAEConfig, name)())
    # the published width's parameter count against the JAX eval_shape (1.47B: the DiT, conformer and SSL heads)
    shapes = jax.eval_shape(lambda: jt.ACEStepTransformer(jt.ACEStepConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 4, 8)), jnp.zeros(1), jnp.zeros((1, 5, 768)), jnp.zeros((1, 512)),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3))))
    with torch.device("meta"):
        count = sum(p.numel() for p in ACEStepTransformer(ACEStepConfig()).parameters())
    assert count == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)) == 1_471_214_464


@pytest.mark.parametrize("seq,dim", [(253, 64), (7, 16), (321, 64)])
def test_rope_tables_and_rotation_match_jax(seq, dim):
    cos, sin = pt.qwen2_rope_tables(seq, dim, 1e6)
    jcos, jsin = jt.qwen2_rope_tables(seq, dim, 1e6)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    assert pt.qwen2_rope_tables(seq, dim, 1e6)[0] is cos  # made once per length and device
    x = np.random.default_rng(seq).standard_normal((2, seq, 3, dim)).astype(np.float32)
    assert rel(pt.qwen2_apply_rope(t(x), cos, sin).numpy(), jt.qwen2_apply_rope(jnp.asarray(x), jcos, jsin)) < 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_lite_la_attention_matches_jax(masked):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 9, 3, 16)).astype(np.float32) for _ in range(3))
    mask = (np.arange(9)[None] < np.asarray([[9], [5]])).astype(np.float32) if masked else None
    ours = pt.lite_la_attention(t(q), t(k), t(v), None if mask is None else t(mask)).numpy()
    theirs = np.asarray(jt.lite_la_attention(q, k, v, mask))
    assert rel(ours, theirs) < F32_REL


def test_rel_pos_table_shift_and_conformer_match_jax():
    """The (2T - 1, D) table bitwise, ``_rel_shift`` exactly, and the lyric
    encoder (embed, a conformer layer with padded keys, after-norm) within
    ``F32_REL`` through one seeded tree."""
    np.testing.assert_array_equal(pt.espnet_rel_pos(11, 32).numpy(), np.asarray(jt.espnet_rel_pos(11, 32)))
    x = np.random.default_rng(2).standard_normal((2, 3, 5, 9)).astype(np.float32)
    np.testing.assert_array_equal(pt._rel_shift(t(x)).numpy(), np.asarray(jt._rel_shift(jnp.asarray(x))))
    arch, jarch = _tiny(lyric_depth=2)
    *_, ids, mask, _ = _inputs(arch, lyric=11)
    jenc = jt.LyricEncoder(jarch, dtype=jnp.float32)
    variables = numpy_variables(jenc, ids, mask, seed=3)
    enc = bridge(variables, pt.LyricEncoder(arch, torch.float32))
    ours = enc(t(ids), t(mask)).detach().numpy()
    assert ours.shape == (2, 11, 32) and rel(ours, np.asarray(jenc.apply(variables, ids, mask))) < F32_REL


def test_block_matches_jax():
    """One block: the cross-attention through the op (query ids from the
    latent mask, key ids 1 / -1 from the conditioning mask) against the JAX
    dense masked softmax with ``nan_to_num``; the masked latent rows' cross
    output is 0 on both sides, so the block output matches everywhere."""
    arch, jarch = _tiny()
    rng = np.random.default_rng(4)
    dim = arch.inner_dim
    x, context = rng.standard_normal((2, 10, dim)).astype(np.float32), rng.standard_normal((2, 8, dim)).astype(
        np.float32)
    temb6 = rng.standard_normal((2, 6 * dim)).astype(np.float32)
    latent_mask = np.ones((2, 10), np.float32)
    latent_mask[1, 7:] = 0
    context_mask = np.ones((2, 8), np.float32)
    context_mask[0, 5:] = 0
    rope_self, rope_cross = jt.qwen2_rope_tables(10, 16, 1e6), jt.qwen2_rope_tables(8, 16, 1e6)
    jblock = jt.ACEStepBlock(jarch, dtype=jnp.float32, lora_rank=2)
    variables = numpy_variables(jblock, x, context, temb6, rope_self, rope_cross, latent_mask, context_mask, seed=5)
    block = bridge(variables, pt.ACEStepBlock(arch, torch.float32, lora_rank=2))
    q_seg = t((latent_mask == 1).astype(np.int32))
    kv_seg = t(np.where(context_mask == 1, 1, -1).astype(np.int32))
    ours = block(t(x), t(context), t(temb6), pt.qwen2_rope_tables(10, 16, 1e6), pt.qwen2_rope_tables(8, 16, 1e6),
                 t(latent_mask), q_seg, kv_seg).detach().numpy()
    theirs = np.asarray(jblock.apply(variables, x, context, temb6, rope_self, rope_cross, latent_mask, context_mask))
    assert rel(ours, theirs) < F32_REL


@pytest.mark.parametrize("variant", ["plain", "remat", "mel2"])
def test_transformer_forward_and_lora_grads_match_jax(variant):
    """The tiny DiT (f32, rank-4 adapters) with speaker embeds, padded lyrics
    and a padded caption: the output within ``F32_REL``, and the LoRA
    gradients of a seeded projection of it against ``jax.grad`` within
    ``GRAD_REL`` per adapter (the eight attention projections of each block
    and ``final_proj``; the conformer and embedders have none, as in JAX);
    ``mel2`` runs the patch conv over a mel height of 2."""
    arch, jarch = _tiny(latent_height=2) if variant == "mel2" else _tiny()
    remat = variant == "remat"
    latents, timesteps, text_embeds, speaker, ids, lyric_mask, text_mask = _inputs(arch)
    weight = np.random.default_rng(9).standard_normal(latents.shape).astype(np.float32)
    args = (latents, timesteps, text_embeds, speaker, ids, lyric_mask, text_mask)
    jmodule = jt.ACEStepTransformer(config=jarch, dtype=jnp.float32, lora_rank=4, remat=remat)
    variables = numpy_variables(jmodule, *args, seed=1)
    port = bridge(variables, ACEStepTransformer(arch, dtype=torch.float32, lora_rank=4, remat=remat))

    def jax_loss(lora):
        out = jmodule.apply({"params": variables["params"], "lora": lora}, *args)
        return jnp.sum(out * weight), out

    (_, ref), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables["lora"])
    adapters = tl.freeze_base(port)
    out = port(*(t(a) for a in args))
    assert tuple(out.shape) == ref.shape == latents.shape and out.dtype == torch.float32
    assert rel(out.detach().numpy(), ref) < F32_REL
    (out * t(weight)).sum().backward()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert sorted(flat) == sorted(adapters) and "block_1/cross_k/lora_A" in flat and "final_proj/lora_B" in flat
    assert not any(k.startswith(("lyric", "t_block", "speaker")) for k in flat)
    for path, param in adapters.items():
        assert param.grad is not None and rel(param.grad.numpy().T, flat[path]) < GRAD_REL, path


def test_transformer_bf16_matches_jax():
    """The default compute dtype on both sides (bf16 products, f32 norms,
    modulation and attention softmax): within ``BF16_REL``."""
    arch, jarch = _tiny()
    args = _inputs(arch)
    jmodule = jt.ACEStepTransformer(config=jarch)
    variables = numpy_variables(jmodule, *args, seed=2)
    out = bridge(variables, ACEStepTransformer(arch))(*(t(a) for a in args)).detach().numpy()
    ref = np.asarray(jmodule.apply(variables, *args))
    assert out.dtype == np.float32 and rel(out, ref) < BF16_REL


# ---- lyrics ----------------------------------------------------------------------------------------


def test_lyric_ids_match_jax(tmp_path, monkeypatch):
    """The ids and masks of a batch (a sidecar-style lyric with structure
    markers, blank lines and punctuation; an empty lyric; a long one past
    64 ids) on a seeded BPE vocab: equal to the JAX tokenizer's, from the
    model dir's ``lyrics_utils/vocab.json`` and from
    ``SIMPLETUNER_LYRICS_VOCAB``; a CJK line refused by both."""
    write_lyrics_vocab(tmp_path / "model" / "lyrics_utils" / "vocab.json")
    batch = [LYRICS, "", " ".join(["the singer sings"] * 12), None]
    ours = LyricsTokenizer(model_path=str(tmp_path / "model")).tokenize_batch(batch)
    theirs = JaxLyricsTokenizer(model_path=str(tmp_path / "model")).tokenize_batch(batch)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape[1] % 64 == 0 and ours[0].shape[1] > 64 and ours[0][0, 0] == 261
    assert ours[1][1].sum() == 0 and (ours[0] == 2).any()
    monkeypatch.setenv("SIMPLETUNER_LYRICS_VOCAB", write_lyrics_vocab(tmp_path / "env" / "vocab.json", 300))
    np.testing.assert_array_equal(LyricsTokenizer().tokenize_batch([LYRICS])[0],
                                  JaxLyricsTokenizer().tokenize_batch([LYRICS])[0])
    for tokenizer in (LyricsTokenizer(), JaxLyricsTokenizer()):
        with pytest.raises(NotImplementedError, match="transliteration"):
            tokenizer.tokenize("雨の夜")
    monkeypatch.delenv("SIMPLETUNER_LYRICS_VOCAB")
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        LyricsTokenizer(model_path=str(tmp_path / "nowhere")).tokenize("la la")


# ---- import, key map and the family contract -----------------------------------------------------------


def _seeded_file(arch, path, seed):
    rng = np.random.default_rng(seed)
    tensors = {}
    for name, shape in acestep_checkpoint_shapes(arch).items():
        scale = 1.0 / np.sqrt(np.prod(shape[1:])) if len(shape) > 1 else 0.1
        tensors[name] = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
        if len(shape) == 1 and ("norm" in name or "early_conv_layers.1" in name or "embed.out.1" in name) \
                and name.endswith("weight"):
            tensors[name] = 1.0 + tensors[name]
    save_safetensors(tensors, str(path))
    return str(path)


def test_import_matches_jax_bitwise(tmp_path):
    """A seeded file in the diffusers layout (``acestep_checkpoint_shapes``):
    the port's tree bitwise the JAX ``load_acestep_params`` tree, and the
    imported module bitwise the bridged JAX tree; the layout's names are
    exactly the ones the JAX importer reads."""
    model = ACEStep(config_namespace({"model_family": "ace_step", "model_arch_preset": "tiny"}))
    jmodel = JaxACEStep(JaxTrainingConfig({"model_family": "ace_step", "model_arch_preset": "tiny"}))
    path = _seeded_file(model.arch, tmp_path / "ace.safetensors", 6)
    theirs = jax_load_acestep_params(jmodel, path)
    _assert_trees_bitwise(load_acestep_params(model, path), theirs)
    ours = load_transformer_params(model, tl.init_adapters(model.create_module()), path)
    reference = load_flax_params(tl.init_parameters(model.create_module()),
                                 jax.tree_util.tree_map(np.asarray, theirs), keep_adapters=True)
    for (name, a), b in zip(ours.state_dict().items(), reference.state_dict().values()):
        if name.rsplit(".", 1)[-1] not in tl.LORA_LEAVES:
            assert torch.equal(a, b), name
    assert ours.block_0.ff.depth.weight.shape == (256, 1, 3) and ours.projector_0_2.weight.shape == (24, 64)


def test_key_map_matches_jax():
    for arch, jarch in ((ACEStepConfig(), jt.ACEStepConfig()), _tiny()):
        assert acestep_key_map(arch) == jax_acestep_key_map(jarch)


def test_family_contract_matches_jax(tmp_path):
    """The LoRA presets (the default adapts the eight attention projections
    of every block and nothing else, as the JAX predicate does), the sidecar
    lyrics of the collate hook, ``validation_lyrics`` in a render's
    conditioning, the intermediates tap refused by name, the mel reshape
    refused where the JAX reshape raises, and the flow-matching check."""
    values = {"model_family": "ace_step", "model_type": "lora", "lora_rank": 2, "model_arch_preset": "tiny",
              "mixed_precision": "fp32"}
    model, jmodel = ACEStep(config_namespace(values)), JaxACEStep(JaxTrainingConfig(values))
    for preset in (None, "attn_qkv", "attn_qkv+linear_qkv+speech_embedder"):
        model.config.acestep_lora_target = jmodel.config.acestep_lora_target = preset
        assert model.family_lora_targets() == jmodel.family_lora_targets()
    model.config.acestep_lora_target = "nope"
    with pytest.raises(ValueError, match="unknown acestep_lora_target"):
        model.family_lora_targets()
    model.config.acestep_lora_target = None
    adapted = {path.rsplit("/", 1)[0] for path in tl.lora_parameters(model.create_module())}
    assert adapted == {f"block_{i}/{kind}_{p}" for i in range(2) for kind in ("attn", "cross")
                       for p in ("q", "k", "v", "proj")}
    assert model.latent_channels == 4 and model.audio_vae_config() == AudioVAEConfig.tiny()

    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend

    data = tmp_path / "data"
    data.mkdir()
    (data / "a.lyrics.txt").write_text(LYRICS)
    vocab = write_lyrics_vocab(tmp_path / "v" / "vocab.json")

    class Bundle:
        data_backend = LocalDataBackend("d", str(data))

        class metadata_backend:  # noqa: N801 (a stand-in namespace)
            image_metadata = {str(data / "b.wav"): {"row": {"lyrics": "the end"}}}

    batch = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SIMPLETUNER_LYRICS_VOCAB", vocab)
        model.collate_batch_extras([{"image_path": str(data / "a.wav")}, {"image_path": str(data / "b.wav")},
                                    {"image_path": str(data / "c.wav")}], Bundle, batch)
        ids, mask = JaxLyricsTokenizer().tokenize_batch([LYRICS, "the end", None])
        model.config.validation_lyrics = "la la"
        cond = model.inference_conditioning({"text_embeds": torch.zeros((2, 3, 16))})
    np.testing.assert_array_equal(batch["lyrics_tokens"], ids)
    np.testing.assert_array_equal(batch["lyrics_mask"], mask)
    assert cond["lyrics_tokens"].shape[0] == 2 and cond["lyrics_mask"].sum() > 0
    empty = {}
    model.collate_batch_extras([{"image_path": str(data / "c.wav")}], Bundle, empty)
    assert empty == {}  # tags-only: no sample has lyrics
    with pytest.raises(NotImplementedError, match="item 4h"):
        model.model_predict_with_intermediates(None, {})

    full = {**values, "model_arch_preset": None}
    model, jmodel = ACEStep(config_namespace(full)), JaxACEStep(JaxTrainingConfig(full))
    latents = np.zeros((1, 430, 8), np.float32)  # 5 s at 44.1 kHz: 430 latents
    with pytest.raises(TypeError):  # the JAX reshape
        jmodel._to_mel_layout(jnp.asarray(latents))
    with pytest.raises(ValueError, match="S = 430 does not"):
        model._to_mel_layout(t(latents))
    assert tuple(model._to_mel_layout(t(np.zeros((1, 4048, 8), np.float32))).shape) == (1, 16, 253, 8)
    with pytest.raises(ValueError, match="flow-matching"):
        ACEStep(config_namespace({**values, "prediction_type": "epsilon"})).check_user_config()


# ---- the trainer and the render -----------------------------------------------------------------


def _write_tracks(directory):
    """Four 1 s mono WAVs at 4 kHz (250 tiny latents each) with captions and lyrics sidecars."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(4):
        data = (np.clip(rng.standard_normal(4000) * 0.2, -1, 1) * 32767).astype(np.int16)
        wavfile.write(os.path.join(directory, f"track_{i}.wav"), 4000, data)
        with open(os.path.join(directory, f"track_{i}.txt"), "w") as handle:
            handle.write(f"song {i}")
        if i != 3:  # one track without lyrics: a masked 0 in its batch row
            with open(os.path.join(directory, f"track_{i}.lyrics.txt"), "w") as handle:
                handle.write(LYRICS if i % 2 else "[verse]\nthe rain and the night")


def _trainer_values(root, out, **extra):
    return {
        "model_family": "ace_step", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
        "optimizer": "adamw", "learning_rate": 1e-3, "lr_scheduler": "constant", "max_train_steps": 2,
        "train_batch_size": 2, "report_to": "jsonl", "mixed_precision": "fp32", "cache_dir": str(root / "cache"),
        "output_dir": str(root / out), "checkpointing_steps": 2, "seed": 42,
        "data_backend_config": [
            {"id": "tracks", "dataset_type": "audio", "type": "local", "instance_data_dir": str(root / "data"),
             "caption_strategy": "textfile", "cache_dir_vae": str(root / "cache" / "vae"), "repeats": 1,
             "audio": {"max_duration": 1.0}},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": str(root / "cache" / "text")},
        ],
        **extra,
    }


def _wide_lyrics(mp):
    """The tiny archs with a lyric table past the tokenizer's start id (261)
    in both packages: the tiny table (64 rows) would read NaN rows."""
    ours, theirs = _tiny(lyric_vocab=512)
    mp.setattr(jt.ACEStepConfig, "tiny", classmethod(lambda cls: theirs))
    mp.setattr(ACEStepConfig, "tiny", classmethod(lambda cls: ours))


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny ACE-Step from one
    seeded diffusers-layout file, warm-started from one seeded adapter, 2
    steps of batch 2 over four lyric-carrying tracks with the same noise and
    sigmas.  The JAX run writes the audio latent cache with its audio VAE;
    the port reads it."""
    from simpletuner_tpu import native as jax_native
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_trainer import _overriding

    root = tmp_path_factory.mktemp("ace_trainer")
    _write_tracks(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    with pytest.MonkeyPatch.context() as mp:
        _wide_lyrics(mp)
        mp.setenv("SIMPLETUNER_LYRICS_VOCAB", write_lyrics_vocab(root / "vocab" / "vocab.json"))
        port_model = ACEStep(config_namespace(_trainer_values(root, "x")))
        path = _seeded_file(port_model.arch, root / "ace.safetensors", 3)
        module = tl.init_parameters(port_model.create_module(), torch.Generator().manual_seed(4))
        rng = np.random.default_rng(4)
        with torch.no_grad():
            for param in tl.lora_parameters(module).values():
                param.copy_(torch.from_numpy(0.05 * rng.standard_normal(tuple(param.shape)).astype(np.float32)))
        lora_path = str(root / "init_lora.safetensors")
        save_lora_safetensors(port_model, module, lora_path)
        extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
        cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "ace_step")
        rng = np.random.default_rng(5)
        for i in range(4):
            cache.save(f"song {i}", {"text_embeds": rng.standard_normal((6, 16)).astype(np.float32),
                                     "attention_mask": (np.arange(6) < 4).astype(np.int32)})
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_trainer_values(root, "jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=_trainer_values(root, "port", **extra), device="cpu")
        port_trainer.run()
        batch = port_trainer.data_plane.iterator.next_batch()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer, batch


def test_trainer_matches_jax(trainer_runs):
    """2 steps over (B, 250, 4) audio latents with lyric ids, no state shared
    between the runs: per-step loss within 1e-5 relative
    (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA export
    holds the JAX map's names and, within ``GRAD_REL`` in relative L2, its
    tensors; both trainers built the tiny audio VAE and discovered the
    ``1s`` bucket."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer, batch = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(".cross_attn.to_q.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    assert isinstance(port_trainer.vae, AudioAutoencoderKL) and port_trainer.vae.config == AudioVAEConfig.tiny()
    bundle = port_trainer.data_plane.bundles["tracks"]
    assert sorted(bundle.metadata_backend.aspect_ratio_bucket_indices) == ["1s"]
    assert bundle.vae_cache.load(bundle.metadata_backend.aspect_ratio_bucket_indices["1s"][0]).shape == (250, 4)
    assert batch["latents"].shape == (2, 250, 4) and batch["lyrics_tokens"].shape[1] % 64 == 0


def test_cfg_render_writes_the_jax_wav(tmp_path, monkeypatch):
    """A true-CFG flow Euler render with ``validation_lyrics`` through each
    package's ``Validation`` (seeded caption and negative embeds, the same
    DiT weights and noise), 3 guided steps over 1 s at 4 kHz (250 latents),
    decoded by the tiny audio VAE on one seeded tree (f32): the latents
    within 1e-4 (f32 renders, sum order only), the samples within 1e-4, and
    the WAV's int16 samples within one level of the JAX file's; the render
    returns no path for a waveform, as the JAX pass does."""
    _wide_lyrics(monkeypatch)
    monkeypatch.setenv("SIMPLETUNER_LYRICS_VOCAB", write_lyrics_vocab(tmp_path / "vocab.json"))
    config = {"model_family": "ace_step", "model_type": "full", "model_arch_preset": "tiny", "mixed_precision": "fp32",
              "validation_prompt": "a song", "validation_guidance": 3.0, "validation_num_inference_steps": 3,
              "validation_seed": 7, "validation_audio_duration": 1.0, "validation_audio_sample_rate": 4000,
              "validation_lyrics": LYRICS}
    model, jmodel = ACEStep(config_namespace(config)), JaxACEStep(JaxTrainingConfig(config))
    args = _inputs(model.arch)
    jmodule = jt.ACEStepTransformer(config=jmodel.arch, dtype=jnp.float32)
    variables = numpy_variables(jmodule, *args, seed=8)
    module = bridge(variables, model.create_module())
    jvae = JaxAudioVAE(JaxAudioVAEConfig.tiny(), dtype=jnp.float32)
    vae_vars = numpy_variables(jvae, jnp.zeros((1, 64, 1)), seed=6)
    vae = bridge(vae_vars, AudioAutoencoderKL(AudioVAEConfig.tiny(), torch.float32))
    rng = np.random.default_rng(12)
    embeds = {"text_embeds": rng.standard_normal((6, 16)).astype(np.float32), "attention_mask": np.ones(6, np.int32)}
    negative = {"text_embeds": rng.standard_normal((6, 16)).astype(np.float32), "attention_mask": np.ones(6, np.int32)}
    validation = Validation(model, config_namespace(config), decode_fn=vae.decode, output_dir=str(tmp_path / "port"),
                            device="cpu")
    validation._embeds, validation._negative_embeds = [embeds], negative
    assert validation._latent_shape(1) == (1, 250, 4)
    latents = Validation(model, config_namespace(config), device="cpu")
    latents._embeds, latents._negative_embeds = [embeds], negative
    latents = latents._render_single(module, embeds, 0)
    noise = torch.randn((1, 250, 4), generator=noise_generator(7, 0)).numpy()
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(noise))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    jlatents = JaxValidation(jmodel, JaxTrainingConfig(config))
    jlatents._embeds, jlatents._negative_embeds = [embeds], negative
    ref = np.asarray(jlatents._render_single(jvars, embeds, 0))
    assert latents.shape == ref.shape == (250, 4) and rel(latents, ref) < 1e-4
    jvalidation = JaxValidation(jmodel, JaxTrainingConfig(config), output_dir=str(tmp_path / "jax"),
                                decode_fn=lambda z: jvae.apply(vae_vars, z, method=JaxAudioVAE.decode))
    jvalidation._embeds, jvalidation._negative_embeds = [embeds], negative
    wave, jwave = validation._render_single(module, embeds, 0), np.asarray(jvalidation._render_single(jvars, embeds, 0))
    assert wave.dtype == np.float32 and wave.shape == jwave.shape == (4000, 1) and rel(wave, jwave) < 1e-4
    assert validation.run_validations(module, 3, force=True) == jvalidation.run_validations(jvars, 3, force=True) == []
    rate, ours = wavfile.read(str(tmp_path / "port" / "validation" / "step_3_0.wav"))
    jrate, theirs = wavfile.read(str(tmp_path / "jax" / "validation" / "step_3_0.wav"))
    assert rate == jrate == 4000 and ours.dtype == theirs.dtype == np.int16 and ours.shape == theirs.shape == (4000,)
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1
