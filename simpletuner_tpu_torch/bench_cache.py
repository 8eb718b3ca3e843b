"""Caching-pass throughput of the torch port on one NVIDIA GPU.

    python -m simpletuner_tpu_torch.bench_cache

The counterpart of the root ``bench_cache.py``, with its two rows:

* **VAE cache**: ``VAECache.process_buckets`` end to end over mixed-aspect
  JPEGs near the 1024^2 area (1024x1024, 1152x896, 896x1152: three buckets),
  written in the run from a seed: host threads decode and resize, uint8
  batches of 8 cross to the card and are normalized there, an SDXL-size
  AutoencoderKL encoder (seeded weights, bf16) encodes them, writer threads
  persist reference-layout ``.pt`` files.  96 images.
* **text cache**: ``TextEmbeddingCache.compute_embeddings_for_prompts`` end
  to end over a T5-XXL-size encoder (4.76B parameters, seeded, bf16) at
  sequence 512 (the Flux recipe), batches of 16, 96 prompts, thread-pool
  ``.pt`` writes.

Each row reports the rate end to end (images/s, prompts/s: wall clock over
the whole pass after one warm-up batch per shape), the rate on the device
(CUDA events around the encoder on a resident batch), the MFU of each
against the dense bf16 peak (989 TFLOP/s for an H100 SXM) with the FLOP
formulas of the root ``bench_cache.py`` (convolutions and the mid attention
of the encoder; 2 x parameters x tokens for T5), and the peak device memory.
The card's name and power limit ride in the last line, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
SOURCE_SIZES = ((1024, 1024), (1152, 896), (896, 1152))  # (width, height): three 1024^2-area buckets
IMAGES, VAE_BATCH, WORKERS = 96, 8, 8  # the root bench_cache.py's VAE row
PROMPTS, TEXT_BATCH, SEQ = 96, 16, 512  # its text row: the Flux recipe's T5 length
WORDS = ("photo", "of", "a", "scenic", "mountain", "lake", "at", "dawn", "with", "mist", "dramatic", "light",
         "film", "grain", "portrait", "city", "street", "night", "neon", "rain")


def vae_encoder_flops(height: int, width: int, cfg) -> float:
    """Matmul-equivalent FLOPs of one AutoencoderKL encode at (H, W) (the
    formula of the root bench_cache.py)."""
    total = 0.0

    def conv(h, w, cin, cout, k):
        return 2.0 * h * w * cin * cout * k * k

    ch = cfg.base_channels
    h, w = height, width
    total += conv(h, w, cfg.in_channels, ch, 3)  # conv_in
    cin = ch
    for level, mult in enumerate(cfg.channel_multipliers):
        cout = ch * mult
        for _ in range(cfg.layers_per_block):
            total += conv(h, w, cin, cout, 3) + conv(h, w, cout, cout, 3)
            if cin != cout:
                total += conv(h, w, cin, cout, 1)
            cin = cout
        if level < len(cfg.channel_multipliers) - 1:
            h, w = h // 2, w // 2
            total += conv(h, w, cout, cout, 3)  # downsample
    total += 2 * (conv(h, w, cin, cin, 3) * 2)  # mid resnets
    seq = h * w
    total += 4 * (2.0 * seq * cin * cin)  # qkvo projections
    total += 2 * (2.0 * seq * seq * cin)  # QK^T + PV
    total += conv(h, w, cin, 2 * cfg.latent_channels, 3)  # conv_out (moments)
    return total


def t5_encoder_flops(n_params: float, tokens: int) -> float:
    return 2.0 * n_params * tokens


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def write_images(directory: str, count: int, sizes: Sequence[Tuple[int, int]] = SOURCE_SIZES, seed: int = 0,
                 fmt: str = "jpg") -> List[str]:
    """``count`` photo-like images (smooth colour waves plus noise), cycling
    through ``sizes``, written with PIL; returns their paths."""
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(count):
        w, h = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([127 + 80 * np.sin(xx / (120.0 + 30 * c) + i + c) * np.cos(yy / (200.0 + 17 * c))
                         for c in range(3)], axis=-1)
        pixels = np.clip(base + rng.normal(0, 6, base.shape), 0, 255).astype(np.uint8)
        path = os.path.join(directory, f"img_{i:04d}.{fmt}")
        Image.fromarray(pixels).save(path, **({"quality": 90} if fmt == "jpg" else {}))
        paths.append(path)
    return paths


def prompts_for(count: int, seed: int = 1) -> List[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=32)) + f" #{i}" for i in range(count)]


def vae_row() -> Dict:
    from .caching.vae_cache import VAECache
    from .data.backends.local import LocalDataBackend
    from .data.buckets import BucketConfig, target_size_for_aspect
    from .data.metadata import MetadataBackend
    from .models.layers import init_parameters
    from .models.vae import AutoencoderKL, VAEConfig
    from .training.trainer import vae_encode_fn

    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="bench_vae_cache_")
    try:
        data_dir = os.path.join(root, "data")
        start = time.perf_counter()
        write_images(data_dir, IMAGES)
        write_s = time.perf_counter() - start
        backend = LocalDataBackend("bench", instance_data_dir=data_dir)
        buckets = BucketConfig(resolution=1024, resolution_type="pixel_area", crop=False)
        metadata = MetadataBackend("bench", backend, buckets, instance_data_dir=data_dir,
                                   cache_file=os.path.join(root, "buckets.json"),
                                   metadata_file=os.path.join(root, "meta.json"))
        metadata.discover()
        cfg = VAEConfig.sdxl()
        with torch.device(dev):
            vae = init_parameters(AutoencoderKL(cfg, torch.bfloat16), torch.Generator(device=dev).manual_seed(0)).eval()
        encode = vae_encode_fn(vae, dev)
        cache = VAECache("bench", backend, metadata, os.path.join(root, "cache"), encode_fn=encode,
                         bucket_config=buckets, instance_data_dir=data_dir, batch_size=VAE_BATCH,
                         max_workers=WORKERS, transfer_dtype="uint8")
        shapes = {}
        for key in metadata.aspect_ratio_bucket_indices:  # one warm-up batch per bucket shape
            w, h = target_size_for_aspect(float(key), buckets)
            shapes[key] = (w, h)
            encode(np.zeros((VAE_BATCH, h, w, 3), np.uint8), VAE_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        done = cache.process_buckets()
        e2e_s = time.perf_counter() - start
        if done != IMAGES:
            raise RuntimeError(f"vae cache: {done} of {IMAGES} images cached")
        rng = np.random.default_rng(2)
        batch = torch.from_numpy(rng.integers(0, 256, (VAE_BATCH, 1024, 1024, 3), dtype=np.uint8)).to(dev)
        with torch.no_grad():
            device_ms = cuda_ms(lambda: vae.encode(batch.to(torch.float32) / 127.5 - 1.0), 5)
        peak = torch.cuda.max_memory_allocated() / 2**30
        flops = {key: vae_encoder_flops(h, w, cfg) for key, (w, h) in shapes.items()}
        mean_flops = sum(flops[metadata.image_metadata[p]["bucket"]] for files in
                         metadata.aspect_ratio_bucket_indices.values() for p in files) / IMAGES
        e2e_rate, device_rate = done / e2e_s, VAE_BATCH / (device_ms / 1e3)
        return {
            "images": done, "batch_size": VAE_BATCH, "buckets": {k: len(v) for k, v in
                                                                   metadata.aspect_ratio_bucket_indices.items()},
            "vae": "sdxl", "dtype": "bf16", "params": sum(p.numel() for p in vae.parameters()),
            "source_write_s": write_s, "e2e_s": e2e_s, "e2e_images_per_s": e2e_rate,
            "e2e_mfu": e2e_rate * mean_flops / PEAK_BF16_FLOPS,
            "device_ms_per_batch_1024": device_ms, "device_images_per_s": device_rate,
            "device_mfu": device_rate * vae_encoder_flops(1024, 1024, cfg) / PEAK_BF16_FLOPS,
            "encode_tflop_per_image_1024": vae_encoder_flops(1024, 1024, cfg) / 1e12,
            "peak_gib": peak, "host_cpus": os.cpu_count(), "workers": WORKERS,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def text_row() -> Dict:
    from .caching.text_embeds import TextEmbeddingCache
    from .data.backends.local import LocalDataBackend
    from .models.t5 import T5Config, T5EncoderModel
    from .models.text_encoders import _TinyTokenizer, init_encoder

    dev = torch.device("cuda")
    with torch.device(dev):
        model = init_encoder(T5EncoderModel(T5Config.xxl(), torch.bfloat16),
                             torch.Generator(device=dev).manual_seed(0)).eval()
    n_params = sum(p.numel() for p in model.parameters())
    tokenizer = _TinyTokenizer(SEQ)

    @torch.no_grad()
    def encode_fn(batch: Sequence[str]):
        tokens = tokenizer(list(batch))
        ids = torch.from_numpy(tokens["input_ids"]).to(dev)
        mask = torch.from_numpy(tokens["attention_mask"]).to(dev)
        # fp16 leaves the card (the reference caches half precision)
        out = model(ids, mask)["last_hidden_state"].to(torch.float16).cpu().numpy()
        return [{"last_hidden_state": out[i], "attention_mask": tokens["attention_mask"][i]}
                for i in range(len(batch))]

    texts = prompts_for(PROMPTS)
    root = tempfile.mkdtemp(prefix="bench_text_cache_")
    try:
        cache = TextEmbeddingCache("bench", LocalDataBackend("bench"), root, "t5xxl", encode_fn=encode_fn,
                                   batch_size=TEXT_BATCH, max_workers=WORKERS)
        encode_fn(texts[:TEXT_BATCH])  # warm-up, writes nothing
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        cache.compute_embeddings_for_prompts(texts)
        e2e_s = time.perf_counter() - start
        written = len([f for f in os.listdir(root) if f.endswith(".pt")])
        if written != PROMPTS:
            raise RuntimeError(f"text cache: {written} of {PROMPTS} prompts cached")
        tokens = tokenizer(texts[:TEXT_BATCH])
        ids, mask = torch.from_numpy(tokens["input_ids"]).to(dev), torch.from_numpy(tokens["attention_mask"]).to(dev)
        with torch.no_grad():
            device_ms = cuda_ms(lambda: model(ids, mask), 5)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        shutil.rmtree(root, ignore_errors=True)
    flops = t5_encoder_flops(n_params, SEQ)
    e2e_rate, device_rate = PROMPTS / e2e_s, TEXT_BATCH / (device_ms / 1e3)
    return {
        "prompts": PROMPTS, "batch_size": TEXT_BATCH, "seq": SEQ, "params": n_params, "dtype": "bf16",
        "e2e_s": e2e_s, "e2e_prompts_per_s": e2e_rate, "e2e_mfu": e2e_rate * flops / PEAK_BF16_FLOPS,
        "device_ms_per_batch": device_ms, "device_prompts_per_s": device_rate,
        "device_mfu": device_rate * flops / PEAK_BF16_FLOPS, "encode_tflop_per_prompt": flops / 1e12,
        "peak_gib": peak,
    }


def nvidia_smi() -> str:
    result = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    argparse.ArgumentParser(prog="python -m simpletuner_tpu_torch.bench_cache",
                            description=__doc__.split("\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_cache: torch.cuda.is_available() is False; the benchmark needs a CUDA device", file=sys.stderr)
        return 2
    rows = {"vae_cache": vae_row()}
    print("vae_cache: " + json.dumps(rows["vae_cache"]), file=sys.stderr, flush=True)
    torch.cuda.empty_cache()
    rows["text_embeds"] = text_row()
    print("text_embeds: " + json.dumps(rows["text_embeds"]), file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": "vae_cache_images_per_s_h100",
        "value": rows["vae_cache"]["e2e_images_per_s"],
        "unit": "images/s end to end",
        "extra": {**rows, "device": torch.cuda.get_device_name(0), "card": nvidia_smi()},
    }), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
