"""The torch port's trainer on LongCat-Video, Sana and Sana-Video against
the JAX ``Trainer``, on the CPU.

For each family both trainers run the tiny preset for 2 steps from the JAX
exporter's file of one seeded tree, warm-started from one seeded adapter, on
one text cache, with the same noise and sigmas (the Flux trainer test's
recipe): the two video families over four 9-frame mp4 clips at 32 x 32 in
one video bucket (the tiny video VAE at the tiny archs' 4 latent channels,
as both families build it), Sana over four images in two aspect buckets (the
tiny SD VAE's 4 channels; the published 32 channels meet the 16-channel
Flux VAE both trainers build: the wall is held in test_torch_sana.py).  The
payloads: 16 caption states (T5's for LongCat-Video, Gemma's for the Sanas)
with 5 valid, the mask kept by the video families' collates and dropped by
Sana's.  Every tolerance is stated where it is checked.
"""

import importlib

import jax
import numpy as np
import pytest
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.weight_export import _EXPORTERS as JAX_EXPORTERS

from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
from simpletuner_tpu_torch.training.lora import save_lora_safetensors

from test_torch_chroma_trainer import _seeded_adapters
from torch_parity import rel

# gradient-derived numbers (test_torch_sdxl.py: f32 gradients through a deep
# net are a few 1e-5 off float64 on either side)
GRAD_REL = 1e-4
STEPS = 2
# family -> its test module (``_pair``, ``_jax_params``)
FAMILIES = {"longcat_video": "test_torch_longcat_video", "sana": "test_torch_sana",
            "sanavideo": "test_torch_sanavideo"}


def _values(root, out, family, **extra):
    """The tiny recipe: rank 4, AdamW 1e-3, f32, 2 steps; clips or images."""
    if family == "sana":
        from test_torch_trainer import _values as image_values

        return image_values(root, out, model_family=family, max_train_steps=STEPS, checkpointing_steps=STEPS,
                            **extra)
    from test_torch_hunyuanvideo_trainer import _values as video_values

    return video_values(root, out, model_family=family, **extra)


@pytest.fixture(scope="module", params=list(FAMILIES))
def trainer_runs(request, tmp_path_factory):
    from simpletuner_tpu import native as jax_native
    from simpletuner_tpu.data.dataset import MultiDatasetIterator as JaxIterator
    from simpletuner_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from simpletuner_tpu.training import trainer as jax_trainer_module
    from simpletuner_tpu.training.trainer import Trainer as JaxTrainer

    from simpletuner_tpu_torch.caching.text_embeds import TextEmbeddingCache
    from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
    from simpletuner_tpu_torch.data.dataset import MultiDatasetIterator
    from simpletuner_tpu_torch.training.trainer import Trainer

    from test_torch_hunyuanvideo_trainer import _write_clips
    from test_torch_trainer import _overriding, _write_images

    family = request.param
    helpers = importlib.import_module(FAMILIES[family])
    root = tmp_path_factory.mktemp(f"{family}_trainer")
    prefix = "photo" if family == "sana" else "clip"
    (_write_images if family == "sana" else _write_clips)(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    jl.set_lora_target(None)
    jmodel, port_model = helpers._pair(_values(root, "x", family))
    path = str(root / f"{family}.safetensors")
    exported = JAX_EXPORTERS[family](helpers._jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    # the captions' payloads, cached before either run (the tiny tokenizer's
    # salted hash would give every process other embeds)
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), family)
    rng = np.random.default_rng(5)
    for i in range(4):
        cache.save(f"{prefix} {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32),
                                     "attention_mask": (np.arange(16) < 5).astype(np.int32)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        mp.setattr(jax_trainer_module, "build_mesh", lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        mp.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_values(root, "jax", family, **extra)))
        jax_trainer.run()
        mp.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=_values(root, "port", family, **extra), device="cpu")
        port_trainer.run()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return family, root, jax_trainer, port_trainer


def test_trainer_matches_jax(trainer_runs):
    """2 steps, no state shared between the runs: per-step loss within 1e-5
    relative (``TRAJECTORY_TOL``), grad norm within ``GRAD_REL``; the LoRA
    export holds the JAX map's names and, within ``GRAD_REL`` in relative
    L2, its tensors; both trainers built the family and a VAE of 4 latent
    channels (the tiny video VAE for the video families); the port's batches
    carry what the family's collate keeps, at the latents' rank."""
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL

    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    family, root, jax_trainer, port_trainer = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == list(range(1, STEPS + 1))
    for a, b in zip(ours, theirs):
        assert np.isfinite(a["loss"]) and abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), \
            (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = f"checkpoint-{STEPS}/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and len(mine) > 0
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    assert port_trainer.model.NAME == jax_trainer.model.NAME == family
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4
    assert isinstance(port_trainer.vae, VideoAutoencoderKL) == (family != "sana")
    batch = port_trainer._example_batch()
    kept = ["text_embeds"] if family == "sana" else ["text_attention_mask", "text_embeds"]
    assert sorted(k for k in batch if k.startswith("text")) == kept
    assert batch["latents"].ndim == (4 if family == "sana" else 5)
