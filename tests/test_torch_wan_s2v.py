"""The torch port's Wan-S2V family against the JAX package, on the CPU.

The family contract (the ``s2v-14b`` flavour's ``WanConfig.b14()``, the
audio feature width, the example batch, Wan's importer and key map), the
model inputs with the clip's audio features zero-padded or cut to the text
width and joined after the text tokens (the tiny DiT's prediction through
one seeded tree), the speech-to-video pairing of the collate (each clip's
same-stem WAV resampled to ``sample_rate``, its STFT features cut or padded
to ``max_feature_frames``; a clip without one drops the features of the
batch), and two ``Trainer.run()`` steps on mp4 clips with paired WAVs against
the JAX ``Trainer`` on one latent cache.  The same seeded numpy weights,
inputs and noise go through both packages.  Forwards are held within 1e-5
relative L2 (``F32_REL``), gradient-derived numbers within 1e-4
(``GRAD_REL``); the pairing bitwise.  The 640-key cross-attention of the
published width is held on the card (test_torch_kernels_cuda.py,
chip_smoke.py phases 3, 7 and 48).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from safetensors.numpy import save_file as np_save_file
from scipy.io import wavfile

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.data.dataset import collate_batch as jax_collate_batch
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.extended.model import WanS2V as JaxWanS2V
from simpletuner_tpu.models.wan.transformer import WanTransformer as JaxWanTransformer
from simpletuner_tpu.models.weight_export import export_wan_to_diffusers
from simpletuner_tpu.models.weight_import import _IMPORTERS as JAX_IMPORTERS
from simpletuner_tpu.training.lora import _key_map_for as jax_key_map_for

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models.extended import WanS2V
from simpletuner_tpu_torch.models.registry import get_model_family
from simpletuner_tpu_torch.models.wan import WanConfig
from simpletuner_tpu_torch.models.weight_import import _IMPORTERS, load_safetensors_file, load_wan_params
from simpletuner_tpu_torch.training.lora import _key_map_for, save_lora_safetensors

from test_torch_wan import _jax_params, _seeded_adapters, _write_clips
from torch_parity import bridge, rel, t

F32_REL = 1e-5
GRAD_REL = 1e-4


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX model family installs a process-wide LoRA target predicate."""
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    yield
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])


def _values(**extra):
    return {"model_family": "wan_s2v", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
            "mixed_precision": "fp32", **extra}


def _pair(values):
    return JaxWanS2V(JaxTrainingConfig(values)), get_model_family(config_namespace(values))


def test_family_contract_matches_jax():
    """``s2v-14b`` builds ``WanConfig.b14()`` (5120 wide, 40 heads of 128) as
    the JAX family does; ``s2v_audio_feature_dim`` sizes the example batch's
    features; Wan's importer and key map serve the family in both packages."""
    for extra in ({"model_arch_preset": None}, {"s2v_audio_feature_dim": 48}):
        jmodel, model = _pair(_values(**extra))
        assert isinstance(model, WanS2V) and model.flavour == jmodel.flavour == "s2v-14b"
        assert model.arch == WanConfig(**{k: getattr(jmodel.arch, k) for k in model.arch.__dataclass_fields__})
        assert model.audio_feature_dim == jmodel.audio_feature_dim
        batch, jbatch = model.example_batch(2, 64), jmodel.example_batch(2, 64)
        assert sorted(batch) == sorted(jbatch) and tuple(batch["audio_embeds"].shape) == jbatch["audio_embeds"].shape
    assert _pair(_values(model_arch_preset=None))[1].arch == WanConfig.b14()
    assert _IMPORTERS["wan_s2v"] is load_wan_params and JAX_IMPORTERS["wan_s2v"].__name__ == "load_wan_params"
    jmodel, model = _pair(_values())
    assert _key_map_for(model) == jax_key_map_for(jmodel) and len(_key_map_for(model)) == 2 * 10


@pytest.mark.parametrize("features", [24, 32, 40])
def test_model_inputs_and_prediction_match_jax(features):
    """The audio features (B, 7, ``features``) zero-padded or cut to the text
    width (32) and joined after the 5 text tokens (a 12-token context), and
    the tiny DiT's prediction through the family's ``model_predict`` on one
    seeded tree: within ``F32_REL``."""
    jmodel, model = _pair(_values(model_type="full"))
    rng = np.random.default_rng(features)
    prepared = {"noisy_latents": rng.standard_normal((2, 3, 4, 6, 4)).astype(np.float32),
                "timesteps": np.asarray([0.2, 0.7], np.float32),
                "text_embeds": rng.standard_normal((2, 5, 32)).astype(np.float32),
                "audio_embeds": rng.standard_normal((2, 7, features)).astype(np.float32)}
    inputs = model.get_model_inputs({k: t(v) for k, v in prepared.items()})
    jinputs = jmodel.get_model_inputs({k: jnp.asarray(v) for k, v in prepared.items()})
    assert tuple(inputs["context"].shape) == jinputs["context"].shape == (2, 12, 32)
    np.testing.assert_array_equal(inputs["context"].numpy(), np.asarray(jinputs["context"]))
    params = _jax_params(jmodel, 3)
    module = bridge({"params": params}, model.create_module())
    out = model.model_predict(module, {k: t(v) for k, v in prepared.items()}).detach().numpy()
    jmodule = JaxWanTransformer(config=jmodel.arch, dtype=jnp.float32)
    ref = np.asarray(jmodule.apply({"params": params}, **jinputs))
    assert out.shape == ref.shape == (2, 3, 4, 6, 4) and rel(out, ref) < F32_REL
    assert model.inference_conditioning({"text_embeds": 1, "audio_embeds": 2}) == \
        jmodel.inference_conditioning({"text_embeds": 1, "audio_embeds": 2})


def _write_paired(directory, rate=22050, seconds=(1.2, 0.4, 0.9, 2.0)):
    """Four clips (``_write_clips``) with same-stem WAVs of ``seconds`` at ``rate``, mono and stereo."""
    _write_clips(directory)
    rng = np.random.default_rng(21)
    for i, length in enumerate(seconds):
        shape = (int(length * rate), 2) if i % 2 else (int(length * rate),)
        data = (np.clip(rng.standard_normal(shape) * 0.2, -1, 1) * 32767).astype(np.int16)
        wavfile.write(os.path.join(directory, f"clip_{i}.wav"), rate, data)


def _trainer_values(root, out, audio=None, **extra):
    from test_torch_wan import _trainer_values as wan_values

    values = wan_values(root, out, model_family="wan_s2v", **extra)
    values["data_backend_config"][0]["audio"] = audio or {"pair_with_video": True, "max_feature_frames": 40}
    return values


@pytest.mark.parametrize("audio", [{"pair_with_video": True, "max_feature_frames": 40},
                                   {"pair_with_video": True, "sample_rate": 8000, "max_feature_frames": 12}])
def test_collate_pairing_matches_jax(tmp_path, audio):
    """The collated ``audio_embeds`` of two batches bitwise the JAX collate's
    on the same samples (WAVs at 22.05 kHz resampled, features cut and
    padded to ``max_feature_frames``), from the port's and the JAX data
    plane on one directory; without a WAV for a clip, neither collate pairs."""
    from simpletuner_tpu.data.factory import configure_multi_databackend as jax_configure

    from simpletuner_tpu_torch.data.dataset import collate_batch
    from simpletuner_tpu_torch.data.factory import configure_multi_databackend

    _write_paired(tmp_path / "data")
    values = _trainer_values(tmp_path, "x", audio=audio)
    jmodel, model = _pair(values)
    from simpletuner_tpu_torch.configuration import TrainingConfig

    plane = configure_multi_databackend(TrainingConfig(values), model, vae_encode_fn=None, run_caching=False)
    jplane = jax_configure(JaxTrainingConfig(values), jmodel, vae_encode_fn=None, run_caching=False)
    bundle, jbundle = plane.bundles["clips"], jplane.bundles["clips"]
    samples = [{"image_path": str(tmp_path / "data" / f"clip_{i}.mp4"), "bucket": "b", "metadata": {}}
               for i in range(4)]
    for bundle_ in (bundle, jbundle):  # stand-in caches: the pairing reads the data backend only
        bundle_.vae_cache = type("Cache", (), {"get": staticmethod(lambda path: np.zeros((3, 2, 2, 4), np.float32))})()
        bundle_.text_cache = type("Cache", (), {"get": staticmethod(
            lambda caption: {"text_embeds": np.zeros((4, 32), np.float32)})})()
    for batch_samples in (samples[:2], samples[2:]):
        ours = collate_batch(batch_samples, bundle, model)
        theirs = jax_collate_batch(batch_samples, jbundle, jmodel)
        assert ours["audio_embeds"].dtype == theirs["audio_embeds"].dtype == np.float32
        assert ours["audio_embeds"].shape == (2, audio["max_feature_frames"], 64)
        np.testing.assert_array_equal(ours["audio_embeds"], theirs["audio_embeds"])
    os.remove(tmp_path / "data" / "clip_1.wav")
    assert "audio_embeds" not in collate_batch(samples[:2], bundle, model)
    assert "audio_embeds" not in jax_collate_batch(samples[:2], jbundle, jmodel)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The JAX ``Trainer`` and the port's on one cache: tiny Wan-S2V from the
    JAX exporter's file of one seeded tree, warm-started from one seeded
    adapter, 2 steps over four clips in two video buckets, each with its
    paired WAV, with the same noise and sigmas."""
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

    root = tmp_path_factory.mktemp("wan_s2v_trainer")
    _write_paired(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jmodel, port_model = _pair(_trainer_values(root, "x"))
    path = str(root / "wan.safetensors")
    exported = export_wan_to_diffusers(_jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "wan_s2v")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"clip {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                 "attention_mask": (np.arange(16) < 4).astype(np.int32)})
    batches = {}

    def recording(original, name):
        def next_batch(self, step=0):
            batch = original(self, step=step)
            batches.setdefault(name, []).append(batch)
            return batch

        return next_batch

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", recording(_overriding(JaxIterator.next_batch), "jax"))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_trainer_values(root, "jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", recording(_overriding(MultiDatasetIterator.next_batch), "port"))
        port_trainer = Trainer(config=_trainer_values(root, "port", **extra), device="cpu")
        port_trainer.run()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer, batches


def test_trainer_matches_jax(trainer_runs):
    """2 steps with ``audio_embeds`` (40 frames of 64 features, cut to the
    text width 32) joined to the context: per-step loss within 1e-5
    relative (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA
    export holds the JAX map's names and, within ``GRAD_REL`` in relative
    L2, its tensors; the collated features of every step equal the JAX
    run's and a host recomputation from the clip's WAV."""
    from simpletuner_tpu_torch.data.audio import load_audio, waveform_features
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend

    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer, batches = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(".attn2.to_q.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    trained = [b for b in batches["port"] if "override_noise" in b]
    assert trained and all(b["audio_embeds"].shape == (1, 40, 64) for b in trained)
    for ours_batch, jax_batch in zip(trained, [b for b in batches["jax"] if "override_noise" in b]):
        np.testing.assert_array_equal(ours_batch["audio_embeds"], jax_batch["audio_embeds"])
        path = ours_batch["image_paths"][0]
        wave = load_audio(LocalDataBackend("a", str(root / "data")), os.path.splitext(path)[0] + ".wav", 16000)
        feats = waveform_features(wave)[:40]
        expected = np.pad(feats, ((0, 40 - feats.shape[0]), (0, 0)))
        np.testing.assert_array_equal(ours_batch["audio_embeds"][0], expected)
