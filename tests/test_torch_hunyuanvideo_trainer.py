"""The torch port's HunyuanVideo trainer against the JAX ``Trainer``, on the CPU.

Both trainers run tiny HunyuanVideo from the JAX exporter's diffusers file
of one seeded tree, warm-started from one seeded adapter, over four mp4
clips in one video bucket, on one text cache whose payloads carry both
masks (5 of 16 Qwen and 3 of 8 ByT5 tokens valid, so every step runs the
refiner and the joint layers with pads at -1), with the same noise and
sigmas (the Flux trainer test's recipe, cut to 2 steps).  The tiny preset
does not fit together in either package: its video VAE has 4 latent
channels where the tiny arch takes 8, and the T5 builder's tiny encoder
(ByT5's stand-in) is 32 wide where the tiny arch reads 24; so both
packages' tiny video VAE config is given 8 latents and the tiny arch a
ByT5 width of 32 here.  Every tolerance is stated where it is checked.
"""

import dataclasses
import json
import os

import cv2
import jax
import numpy as np
import pytest
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models import video_vae as jax_video_vae
from simpletuner_tpu.models.hunyuanvideo import transformer as jax_hy
from simpletuner_tpu.models.weight_export import export_hunyuanvideo_to_diffusers

from simpletuner_tpu_torch.models import video_vae
from simpletuner_tpu_torch.models.hunyuanvideo import transformer as hy
from simpletuner_tpu_torch.models.weight_import import load_safetensors_file
from simpletuner_tpu_torch.training.lora import save_lora_safetensors

from test_torch_chroma_trainer import _seeded_adapters
from test_torch_hunyuanvideo import GRAD_REL, _jax_params, _pair
from test_torch_video import write_clip
from torch_parity import rel


def _write_clips(directory):
    """Four 9-frame clips at 32x32, with captions."""
    os.makedirs(directory, exist_ok=True)
    for i in range(4):
        write_clip(os.path.join(directory, f"clip_{i}.mp4"), 9, 32, 32, seed=i)
        with open(os.path.join(directory, f"clip_{i}.txt"), "w") as handle:
            handle.write(f"clip {i}")


def _values(root, out, **extra):
    return {
        "model_family": "hunyuanvideo", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
        "optimizer": "adamw", "learning_rate": 1e-3, "lr_scheduler": "constant", "max_train_steps": 2,
        "train_batch_size": 1, "resolution": 40, "report_to": "jsonl", "mixed_precision": "fp32",
        "cache_dir": str(root / "cache"), "output_dir": str(root / out), "checkpointing_steps": 2, "seed": 42,
        "data_backend_config": [
            {"id": "clips", "dataset_type": "video", "type": "local", "instance_data_dir": str(root / "data"),
             "resolution": 40, "resolution_type": "pixel_area", "aspect_bucket_alignment": 16,
             "caption_strategy": "textfile", "cache_dir_vae": str(root / "cache" / "vae"), "repeats": 1,
             "video": {"num_frames": 9}},
            {"id": "embeds", "dataset_type": "text_embeds", "type": "local", "default": True,
             "cache_dir": str(root / "cache" / "text")},
        ],
        **extra,
    }


def _replaced(cls, **fields):
    tiny = cls.tiny
    return classmethod(lambda c: dataclasses.replace(tiny(), **fields))


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
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

    root = tmp_path_factory.mktemp("hunyuanvideo_trainer")
    _write_clips(root / "data")
    previous = jl._LORA_TARGET, jl._QUANTIZED_MATMUL
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_video_vae.VideoVAEConfig, "tiny", _replaced(jax_video_vae.VideoVAEConfig, latent_channels=8))
    mp.setattr(video_vae.VideoVAEConfig, "tiny", _replaced(video_vae.VideoVAEConfig, latent_channels=8))
    mp.setattr(jax_hy.HunyuanVideo15Config, "tiny", _replaced(jax_hy.HunyuanVideo15Config, text2_dim=32))
    mp.setattr(hy.HunyuanVideo15Config, "tiny", _replaced(hy.HunyuanVideo15Config, text2_dim=32))
    jmodel, port_model = _pair(_values(root, "x"))
    path = str(root / "hunyuanvideo.safetensors")
    exported = export_hunyuanvideo_to_diffusers(_jax_params(jmodel, 3), jmodel.arch)
    np_save_file({k: np.ascontiguousarray(v) for k, v in exported.items()}, path)
    lora_path = str(root / "init_lora.safetensors")
    save_lora_safetensors(port_model, _seeded_adapters(port_model, 4, scale=0.05), lora_path)
    extra = {"pretrained_model_name_or_path": path, "init_lora": lora_path}
    cache = TextEmbeddingCache("embeds", LocalDataBackend("embeds"), str(root / "cache" / "text"), "hunyuanvideo")
    rng = np.random.default_rng(5)
    for i in range(4):
        mask = (np.arange(16) < 5).astype(np.int32)
        cache.save(f"clip {i}", {"text_embeds": rng.standard_normal((16, 32)).astype(np.float32), "text_mask": mask,
                                 "text_embeds_2": rng.standard_normal((8, 32)).astype(np.float32),
                                 "text_mask_2": (np.arange(8) < 3).astype(np.int32), "attention_mask": mask})
    with pytest.MonkeyPatch.context() as inner:
        inner.setattr(jax_native, "available", lambda: False)
        inner.setattr(jax_trainer_module, "build_mesh",
                      lambda config: jax_build_mesh(config, devices=jax.devices()[:1]))
        inner.setattr(JaxIterator, "next_batch", _overriding(JaxIterator.next_batch))
        jax_trainer = JaxTrainer(config=JaxTrainingConfig(_values(root, "jax", **extra)))
        jax_trainer.run()
        inner.setattr(MultiDatasetIterator, "next_batch", _overriding(MultiDatasetIterator.next_batch))
        port_trainer = Trainer(config=_values(root, "port", **extra), device="cpu")
        port_trainer.run()
        # the render from the port's checkpoint, with the same tiny VAE
        from simpletuner_tpu_torch.inference import run_inference

        config = root / "render.json"
        config.write_text(json.dumps(_values(root, "port", pretrained_model_name_or_path=path,
                                             validation_resolution=32, validation_num_video_frames=5,
                                             validation_guidance=2.0)))
        rendered = run_inference("a clip of waves", checkpoint=str(root / "port" / "checkpoint-2"),
                                 config_path=str(config), output=str(root / "render"), steps=2, device="cpu")
    mp.undo()
    jl.set_lora_target(previous[0])
    jl.set_quantized_matmul(previous[1])
    return root, jax_trainer, port_trainer, rendered


def test_trainer_matches_jax(trainer_runs):
    """2 steps over 5-D latents, no state shared between the runs: per-step
    loss within 1e-5 relative (``TRAJECTORY_TOL``), grad norm within
    ``GRAD_REL``; the LoRA export holds the JAX map's names and, within
    ``GRAD_REL`` in relative L2, its tensors; the batches carry both masks."""
    from test_torch_trainer import TRAJECTORY_TOL, _metrics

    root, jax_trainer, port_trainer, _ = trainer_runs
    ours, theirs = _metrics(root / "port"), _metrics(root / "jax")
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 2]
    for a, b in zip(ours, theirs):
        assert abs(a["loss"] - b["loss"]) <= TRAJECTORY_TOL * max(1.0, abs(b["loss"])), (a["step"], a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_REL * abs(b["grad_norm"]), (a["step"], a, b)
    export = "checkpoint-2/pytorch_lora_weights.safetensors"
    mine, jax_file = load_safetensors_file(str(root / "port" / export)), load_safetensors_file(str(root / "jax" / export))
    assert sorted(mine) == sorted(jax_file) and any(".attn.add_q_proj.lora_" in k for k in mine)
    keys = sorted(mine)
    assert rel(np.concatenate([mine[k].numpy().ravel() for k in keys]),
               np.concatenate([jax_file[k].numpy().ravel() for k in keys])) < GRAD_REL
    assert port_trainer.model.NAME == jax_trainer.model.NAME == "hunyuanvideo"
    bundle = port_trainer.data_plane.bundles["clips"]
    assert sorted(bundle.metadata_backend.aspect_ratio_bucket_indices) == ["1.0x9"]
    batch = port_trainer._example_batch()
    assert int(batch["text_mask"].sum()) == 5 and int(batch["text_mask_2"].sum()) == 3
    assert batch["latents"].shape[-1] == 8 and "image_embeds" not in batch


def test_checkpoint_inference_writes_mp4(trainer_runs):
    """``run_inference`` (what ``simpletuner-tpu-torch inference --checkpoint``
    runs) from the port's checkpoint-2 on the CPU: the tiny Qwen and T5
    encode the prompt, 2 true-CFG flow Euler steps, one mp4 of 5 frames at
    32 x 32."""
    root, _, _, rendered = trainer_runs
    assert rendered == 0
    output = os.path.join(root, "render", "validation")
    (path,) = [os.path.join(output, f) for f in os.listdir(output)]
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    assert path.endswith(".mp4") and np.stack(frames).shape == (5, 32, 32, 3)
