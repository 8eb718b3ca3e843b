"""The torch port's Kandinsky 5.0 video trainer against the JAX ``Trainer``, on the CPU.

``kandinsky5_video`` at the tiny width over four 9-frame mp4 clips in one
video bucket (the tiny video VAE at the family's 4 latents), with the image
flavour's recipe (test_torch_kandinsky5_trainer.py: one seeded file and
adapter, one text cache, the same noise and sigmas, 2 steps, the tiny arch
at its tiny encoders' widths), then an mp4 render from the port's
checkpoint.  Every tolerance is stated where it is
checked.
"""

import os

import cv2
import numpy as np
import pytest

from test_torch_hunyuanvideo_trainer import _write_clips
from test_torch_kandinsky5_trainer import assert_trajectories_match, run_both, seed_text_cache


def _values(root, out, **extra):
    return {
        "model_family": "kandinsky5_video", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
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


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from simpletuner_tpu import native as jax_native

    root = tmp_path_factory.mktemp("kandinsky5_video_trainer")
    _write_clips(root / "data")
    seed_text_cache(root, "kandinsky5_video", prefix="clip")
    return (root, *run_both(root, lambda out, **extra: _values(root, out, **extra),
                            {"validation_num_video_frames": 5},
                            iterator_patches=[(jax_native, "available", lambda: False)]))


def test_trainer_matches_jax(trainer_runs):
    """The video flavour's trajectory over 5-D latents
    (``assert_trajectories_match``); both trainers built the tiny video VAE
    at 4 latent channels."""
    from simpletuner_tpu_torch.models.video_vae import VideoAutoencoderKL

    root, _, jax_trainer, port_trainer, _ = trainer_runs
    assert_trajectories_match(root)
    assert isinstance(port_trainer.vae, VideoAutoencoderKL)
    assert port_trainer.vae.config.latent_channels == jax_trainer.vae.config.latent_channels == 4
    assert port_trainer._example_batch()["latents"].shape == (1, 3, 16, 16, 4)


def test_checkpoint_inference_writes_mp4(trainer_runs):
    """``run_inference`` from the port's checkpoint-2 on the CPU: one mp4 of
    5 frames at 32 x 32."""
    root, _, _, _, rendered = trainer_runs
    output = os.path.join(root, "render", "validation")
    (clip,) = [os.path.join(output, f) for f in os.listdir(output)]
    cap = cv2.VideoCapture(clip)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    assert rendered == 0 and clip.endswith(".mp4") and np.stack(frames).shape == (5, 32, 32, 3)
