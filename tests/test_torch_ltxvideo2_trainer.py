"""The torch port's trainer on LTX-2 against the JAX ``Trainer``, on the CPU.

Both trainers run the tiny preset for 2 steps from the JAX exporter's file
of one seeded tree, warm-started from one seeded adapter, on one text cache
(16 caption states of 20 channels, 5 valid; the family's collate keeps the
states alone), over four 9-frame mp4 clips at 40 x 40 in one video bucket
(the tiny video VAE at the tiny arch's 8 latent channels, as both families
build it), with the same noise and sigmas (the Flux trainer test's recipe)
and ``ltx2_first_frame_conditioning_probability`` 1, so every step trains on
tokenwise timesteps with the first latent frame clean and out of the loss.
Then the trainer's IC-LoRA reference-video hook in both packages on one
VAE.  Every tolerance is stated where it is checked.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.weight_export import export_ltx2_to_diffusers

from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
from simpletuner_tpu_torch.training.lora import save_lora_safetensors

from test_torch_chroma_trainer import _seeded_adapters
from test_torch_ltxvideo2 import _jax_params, _pair
from torch_parity import bridge, rel

# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
# the video VAE computes in bf16 in both packages: each rounds its own intermediates
BF16_REL = 2e-2
STEPS = 2


def _values(root, out, **extra):
    from test_torch_hunyuanvideo_trainer import _values as video_values

    return video_values(root, out, model_family="ltxvideo2", ltx2_first_frame_conditioning_probability=1.0,
                        **extra)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from simpletuner_tpu import native as jax_native
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_hunyuanvideo_trainer import _write_clips
    from test_torch_trainer import _overriding

    root = tmp_path_factory.mktemp("ltxvideo2_trainer")
    _write_clips(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    jmodel, port_model = _pair(_values(root, "x"))
    path = str(root / "ltxvideo2.safetensors")
    exported = export_ltx2_to_diffusers(_jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "ltxvideo2")
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"clip {i}", {"text_embeds": rng.standard_normal((16, 20)).astype(np.float32),
                                 "attention_mask": (np.arange(16) < 5).astype(np.int32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_values(root, "jax", **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=_values(root, "port", **extra), device="cpu")
        recorded = []
        forward = type(port_trainer.model).predict

        def recording(self, module, prepared):
            recorded.append(tuple(prepared.get("token_timesteps", prepared["timesteps"]).shape))
            return forward(self, module, prepared)

        mp.setattr(type(port_trainer.model), "predict", recording)
        port_trainer.run()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer, recorded


def test_trainer_matches_jax(trainer_runs):
    """2 steps over 5-D latents with the first frame held clean, no state
    shared between the runs: per-step loss within 1e-5 relative
    (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; every step's DiT
    call took tokenwise (1, F H W) timesteps over the latent grid; the LoRA
    export holds the JAX map's names and, within ``GRAD_REL`` in relative L2,
    its tensors; both trainers built the family and the tiny video VAE at 8
    latent channels; the port's batches carry ``text_embeds`` alone."""
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL

    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer, recorded = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == list(range(1, STEPS + 1))
    for a, b in zip(ours, theirs):
        assert np.isfinite(a["loss"]) and abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), \
            (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    batch = port_trainer._example_batch()
    latent = tuple(batch["latents"].shape)
    assert len(latent) == 5 and latent[-1] == 8
    assert recorded and set(recorded) == {(1, latent[1] * latent[2] * latent[3])}
    export = f"checkpoint-{STEPS}/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and len(mine) > 0
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    assert port_trainer.model.NAME == jax_trainer.model.NAME == "ltxvideo2"
    assert isinstance(port_trainer.vae, VideoAutoencoderKL)
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 8
    assert sorted(k for k in batch if k.startswith("text")) == ["text_embeds"]


def test_reference_video_hook_matches_jax(trainer_runs, monkeypatch):
    """``Trainer._init_validation_video_conditioning`` in both packages on
    one VAE (the JAX trainer's, bridged) and one 9-frame reference clip at
    48 x 48 (Lanczos-resized to the 40 px validation resolution) at strength
    0.6: the installed latents within ``BF16_REL`` of JAX's, the strength
    equal; more than one entry refused in both packages."""
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL

    from test_torch_video import write_clip

    root, jax_trainer, port_trainer, _ = trainer_runs
    clip = os.path.join(str(root), "reference.mp4")
    write_clip(clip, 9, 48, 48, seed=9)
    vae = bridge(jax.tree_util.tree_map(np.asarray, jax_trainer.vae_params), VideoAutoencoderKL(
        port_trainer.vae.config, port_trainer.vae.dtype if hasattr(port_trainer.vae, "dtype") else None))
    monkeypatch.setattr(port_trainer, "vae", vae.eval())
    for trainer in (jax_trainer, port_trainer):
        monkeypatch.setattr(trainer.model, "validation_video_conditioning_entries", lambda: [(clip, 0.6)])
        trainer._init_validation_video_conditioning()
    (ours, strength), (theirs, jstrength) = port_trainer.model._validation_ref, jax_trainer.model._validation_ref
    assert strength == jstrength == 0.6 and ours.shape == theirs.shape and ours.shape[0] == 1
    assert rel(ours, theirs) < BF16_REL
    for trainer in (jax_trainer, port_trainer):
        monkeypatch.setattr(trainer.model, "validation_video_conditioning_entries", lambda: [(clip, 1.0)] * 2)
        with pytest.raises(ValueError, match="one validation reference video"):
            trainer._init_validation_video_conditioning()
    assert jnp.asarray(theirs).dtype == jnp.float32
