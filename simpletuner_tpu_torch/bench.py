"""Flux LoRA train-step benchmark on one CUDA device, and its entry point.

PyTorch counterpart of ``bench.py`` (``flagship`` :84-275, the 2.56B proxy of
``main`` :276-395, the entry :396-477) and ``bench.py::flux_step_flops``
(:61).  The flagship is full Flux.1-dev (19 double + 38 single blocks,
hidden 3072, 24 x 128 heads, guidance embedding), a frozen base, rank-16 f32
LoRA on the ``flux_lora_target=all`` modules, AdamW at lr 1e-4, 1024 px (4096
image + 512 T5 tokens, the T5 padding masked), batch 1, and by default the
JAX flagship's base and remat: an int8 frozen base
(``base_model_precision=int8-quanto``) with ``quantized_matmul=full`` (int8
forward and dx products) and remat policy ``attn``.  ``quant="int4"`` packs the
base to 4 bits, ``quant="none"`` keeps it bf16; ``skip_last`` leaves the last
N single-stream blocks unchecked (``BENCH_SKIP_LAST`` in bench.py).

The timed step is the graphed one (``training/train_state.py::
jit_train_step``), as the JAX bench times its jitted step; ``graph=False``
times the eager step, and ``eager_steps`` times the eager step first in the
same process for comparison.

Weights are seeded random (no Flux checkpoint is in the repository), with
the AdaLN modulation weights drawn like every other kernel (their zero init
would close every gate and keep attention off the loss) and every LoRA
tensor at 0.01 (as bench.py:195-198 sets them); the base is quantized after
that, one layer at a time, as ``create_train_state`` does.  MFU counts model
flops only (forward x 3, remat recompute not counted) against the card's
dense bf16 peak, whatever the base, as bench.py:254-255 does.

    python -m simpletuner_tpu_torch.bench

runs the int8 flagship (the headline), the int4 flagship and the 2.56B proxy,
each in its own process so each starts on an empty card, and prints one JSON
object as its last line.  A run that fails makes the entry exit non-zero with
that run's error output.  ``BENCH_FLAGSHIP_STEPS``, ``BENCH_FLAGSHIP_RES``
and the proxy's ``BENCH_BATCH``, ``BENCH_RES``, ``BENCH_STEPS``,
``BENCH_REMAT``, ``BENCH_REMAT_POLICY`` and ``BENCH_QUANT`` override the
sizes, as in the JAX bench.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from .inference import config_namespace
from .models.flux import Flux, FluxConfig
from .models.layers import init_parameters, lecun_normal_, lora_parameters
from .ops import flash_bwd_dkv_kernel, flash_bwd_dq_kernel, flash_fwd_kernel
from .training.optimizers import get_optimizer
from .training.quantization import int8_matmul
from .training.schedules import get_lr_schedule
from .training.train_state import build_train_step, create_train_state, jit_train_step

# dense bf16 tensor-core peaks (NVIDIA data sheets), by device-name fragment
PEAK_FLOPS = (("H100 80GB HBM3", 989e12), ("H100 SXM", 989e12), ("H100 PCIe", 756e12))
KERNELS = (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel)
TXT_LEN = 512  # T5-XXL max length
METRIC = "flux12b_int8_lora_train_mfu_h100"


def peak_flops(device_name: Optional[str] = None) -> float:
    """Dense bf16 peak of the card; an unknown card raises instead of guessing."""
    name = device_name or torch.cuda.get_device_name(0)
    for fragment, flops in PEAK_FLOPS:
        if fragment in name:
            return flops
    raise ValueError(f"no published bf16 peak for {name!r}; add it to PEAK_FLOPS")


def flux_step_flops(arch: FluxConfig, batch: int, s_img: int, s_txt: int) -> float:
    """Analytic model matmul flops of one train step (forward x 3; remat
    recompute is hardware work, not model work), the JAX bench's formula."""
    h = arch.hidden_size
    s = s_img + s_txt
    mlp = arch.mlp_ratio
    double = 2 * h * h * (3 + 1 + 2 * mlp)
    single = 2 * h * h * (3 + mlp) + 2 * h * h * (1 + mlp)
    attn = 4 * s * h
    fwd = batch * s * (arch.depth_double * (double + attn) + arch.depth_single * (single + attn))
    fwd += batch * (s_img * 2 * arch.in_channels * h * 2 + s_txt * 2 * arch.txt_in_features * h)
    return fwd * 3.0


def flagship_config(remat_policy: str = "attn", quant: str = "int8", quantized_matmul: str = "full",
                    skip_last: int = 0) -> Dict:
    """The JAX flagship's training config (bench.py:109-131); ``quant`` is
    "int8", "int4" or "none" (a bf16 base)."""
    if quant not in ("int8", "int4", "none"):
        raise ValueError(f"quant must be int8, int4 or none, got {quant!r}")
    return {
        "model_family": "flux", "model_flavour": "dev", "model_type": "lora", "lora_rank": 16,
        "flux_lora_target": "all", "optimizer": "adamw", "learning_rate": 1e-4, "max_train_steps": 1000,
        "lr_scheduler": "constant", "mixed_precision": "bf16", "gradient_checkpointing": True,
        "gradient_checkpointing_policy": remat_policy, "gradient_checkpointing_skip_last": skip_last,
        "flux_attention_masked_training": True, "quantized_matmul": quantized_matmul,
        "base_model_precision": "no_change" if quant == "none" else f"{quant}-quanto",
    }


@torch.no_grad()
def perturb_adaln(module: torch.nn.Module, generator: torch.Generator) -> None:
    """Give the AdaLN-Zero modulation weights the lecun-normal draw of every other kernel."""
    for name, param in module.named_parameters():
        if name.endswith(("_mod.lin.weight", "modulation.lin.weight")):
            lecun_normal_(param, param.shape[1], generator)


def flagship_batch(arch: FluxConfig, generator: torch.Generator, resolution: int = 1024, batch_size: int = 1,
                   txt_valid: int = 77) -> Dict[str, torch.Tensor]:
    """Seeded latents and prompt embeds; T5 tokens past ``txt_valid`` are padding."""
    dev = generator.device
    latent = resolution // 8
    masks = torch.zeros((batch_size, TXT_LEN), dtype=torch.int64, device=dev)
    masks[:, :txt_valid] = 1
    return {
        "latents": torch.randn((batch_size, latent, latent, arch.in_channels // 4), generator=generator, device=dev),
        "t5_embeds": torch.randn((batch_size, TXT_LEN, arch.txt_in_features), generator=generator, device=dev),
        "pooled_embeds": torch.randn((batch_size, arch.vec_in_features), generator=generator, device=dev),
        "t5_masks": masks,
    }


# kernel-name fragments of each device-time bucket, first match wins
BUCKETS = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("int8_gemm", ("gemm_s8", "imma", "i8i8", "s8s8")),
    # cuDNN convolutions (the UNet's): forward, data and weight gradients
    ("conv", ("fprop", "dgrad", "wgrad", "convolve", "conv2d")),
    ("bf16_gemm", ("gemm", "nvjet", "cutlass", "xmma")),
)


def _bucket(key: str) -> str:
    key = key.lower()
    return next((n for n, tags in BUCKETS if any(tag in key for tag in tags)), "other")


def trace_kernel_launches(prof) -> Dict[str, int]:
    """Launches by kernel bucket as the trace's device-side kernel records
    give them (one record per kernel the card ran, read by name from the
    profiler's raw results), not from ``key_averages()``' aggregation of the
    parsed events."""
    from torch.autograd import DeviceType

    counts = {name: 0 for name, _ in BUCKETS}
    counts["other"] = 0
    for event in prof.profiler.kineto_results.events():
        if event.device_type() == DeviceType.CUDA:
            counts[_bucket(event.name())] += 1
    return counts


def profile_step(step) -> Dict:
    """One call of ``step`` under ``torch.profiler``: device ms by kernel
    bucket (elementwise and copies in ``other``), launches by bucket from
    the trace's kernel records (``trace_kernel_launches``), the launches of
    each flash kernel instance (``flash_fwd_kernel<256, true>``: the head dim
    and the masked mode), the twelve
    kernels with the most device time (name, bucket, launches), the wall time and
    the CUDA-event time of the traced call, and the device's idle share of
    that event time (the profiler lengthens kernels a little, so the share
    against an unprofiled step of a graph replay can come out below 0)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        begin.record()
        step()
        end.record()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    bucket_ms = {name: 0.0 for name, _ in BUCKETS}
    bucket_ms["other"] = 0.0
    instances: Dict[str, int] = {}
    kernels = []
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        name = _bucket(event.key)
        bucket_ms[name] += event.device_time_total / 1e3
        if name.startswith("flash"):
            instance = re.search(r"flash_\w+_kernel<[^>]*>", event.key)
            key = instance.group(0) if instance else event.key[:120]
            instances[key] = instances.get(key, 0) + event.count
        kernels.append((event.device_time_total / 1e3, event.count, event.key[:120], name))
    device_ms = sum(bucket_ms.values())
    top = [{"kernel": key, "bucket": name, "launches": n, "ms": ms} for ms, n, key, name in sorted(kernels, reverse=True)[:12]]
    return {"bucket_ms": bucket_ms, "bucket_launches": trace_kernel_launches(prof), "flash_instances": instances,
            "device_ms": device_ms, "traced_wall_ms": wall_ms, "traced_event_ms": begin.elapsed_time(end),
            "idle_share_traced": 1 - device_ms / begin.elapsed_time(end), "top_kernels": top}


# attempts of the profiled-replay launch check (``replay_launches``)
LAUNCH_CHECK_ATTEMPTS = 3


def replay_launches(step, captured: Mapping[str, int], buckets: Mapping[str, str], profile=profile_step) -> Dict:
    """Profile ``step`` (a CUDA graph's replay) until the trace records
    exactly the launches the capture recorded: ``buckets`` maps each
    counter's name in ``captured`` to its kernel bucket.  A replay launches
    what the capture recorded every time, so a shortfall is the profiler's
    record, not the program: the replay is profiled again, up to
    ``LAUNCH_CHECK_ATTEMPTS`` times in all (``profile`` is the profiler; a
    test fakes it).  Raises at once when an attempt records more launches
    than the capture, and when no attempt records the capture's count.
    Returns the exact attempt's profile with ``launch_attempts``, the counts
    of every attempt."""
    expected = {name: captured[name] for name in buckets}
    tries = []
    for _ in range(LAUNCH_CHECK_ATTEMPTS):
        result = profile(step)
        counts = {name: result["bucket_launches"][bucket] for name, bucket in buckets.items()}
        tries.append(counts)
        if any(counts[name] > expected[name] for name in counts):
            raise RuntimeError(f"the profiled replay recorded more launches than the capture: attempts {tries}, "
                               f"captured {expected}")
        if counts == expected:
            return {**result, "launch_attempts": tries}
    raise RuntimeError(f"no profiled replay recorded the capture's launches in {LAUNCH_CHECK_ATTEMPTS} attempts: "
                       f"{tries}, captured {expected}")


@dataclasses.dataclass
class TrainRun:
    """A seeded LoRA training setup on the card: the model, its state, the
    eager step and one batch."""

    arch: FluxConfig
    model: Flux
    state: Any
    step_fn: Any
    batch: Dict[str, torch.Tensor]
    generator: torch.Generator
    n_params: int
    base_gib: float


def build_run(config: Dict, arch: FluxConfig, seed: int = 0, resolution: int = 1024, batch_size: int = 1,
              txt_valid: int = 77, seeded_adapters: bool = True) -> TrainRun:
    """Model, train state (base quantized as configured), eager step and a
    seeded batch on the card.  ``seeded_adapters`` draws the AdaLN weights
    and sets every LoRA tensor to 0.01 (the flagship); otherwise the module
    keeps its initialisation (the proxy, as bench.py:328-333)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the train benchmark needs a CUDA device")
    dev = torch.device("cuda")
    config = config_namespace(config)
    model = Flux(config, arch=arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        module = init_parameters(model.create_module(), gen)
    if seeded_adapters:
        perturb_adaln(module, gen)
        with torch.no_grad():
            for param in lora_parameters(module).values():
                param.fill_(0.01)
    n_params = sum(p.numel() for p in module.parameters())
    schedule = get_lr_schedule(config, config.max_train_steps)
    tx = get_optimizer(config, schedule)
    state = create_train_state(model, module, tx, quantize_mode=model.base_precision)
    base_gib = sum(t.numel() * t.element_size() for name, t in module.state_dict().items()
                   if name.rpartition(".")[2] not in ("lora_A", "lora_B")) / 2**30
    batch = flagship_batch(arch, gen, resolution, batch_size, txt_valid)
    return TrainRun(arch, model, state, build_train_step(model, tx, schedule), batch, gen, n_params, base_gib)


def time_steps(step: Callable, state, batch, generator, steps: int, warmup: int, profile: bool = False) -> Dict:
    """``warmup`` + ``steps`` calls of ``step`` (eager or graphed), the last
    ``steps`` timed each to a synchronize; the launches per step that the
    kernels' wrappers counted (none for a graph replay, which runs no
    wrapper), peak memory over the timed steps, and with ``profile`` one more
    step under ``torch.profiler``.  Returns the state under ``"state"``."""
    losses = []
    for _ in range(warmup):
        state, metrics = step(state, batch, generator)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = [k.launches for k in KERNELS]
    int_mm = int8_matmul.launches
    step_s = []
    for _ in range(steps):
        start = time.perf_counter()
        state, metrics = step(state, batch, generator)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - start)
        losses.append(metrics["loss"])
    result = {
        "steps": steps,
        "s_per_step": sum(step_s) / steps,
        "s_per_step_median": sorted(step_s)[steps // 2],
        "step_s": step_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches_per_step": {k.name: (k.launches - c) / steps for k, c in zip(KERNELS, counts)},
        "int_mm_per_step": (int8_matmul.launches - int_mm) / steps,
        "losses": [float(x) for x in losses],
        "grad_norm": float(metrics["grad_norm"]),
        "skipped_nonfinite": float(metrics["skipped_nonfinite"]),
    }
    if profile:
        box = {}

        def traced():
            box["state"], _ = step(state, batch, generator)

        traced_result = profile_step(traced)
        state = box["state"]
        traced_result["idle_share_vs_median"] = 1 - traced_result["device_ms"] / 1e3 / result["s_per_step_median"]
        result["profile"] = traced_result
    result["state"] = state
    return result


def flagship(
    steps: int = 20,
    remat_policy: str = "attn",
    warmup: int = 2,
    seed: int = 0,
    resolution: int = 1024,
    quant: str = "int8",
    quantized_matmul: str = "full",
    skip_last: int = 0,
    profile: bool = False,
    graph: bool = True,
    eager_steps: int = 0,
) -> Dict:
    """Train ``warmup`` + ``steps`` LoRA steps of full-width Flux.1-dev on the
    card and time the last ``steps``: graph replays (``graph``, the port's
    train step) or eager steps.  ``eager_steps`` > 0 first times that many
    eager steps (after ``warmup`` more) in the same process, under
    ``"eager"``.  With ``profile``, one more step of each under
    ``torch.profiler`` gives the device time and launches by kernel bucket
    and the device's idle share against the median step; a graph's
    ``launches_per_step`` are the profiled replay's (None unprofiled)."""
    run = build_run(flagship_config(remat_policy, quant, quantized_matmul, skip_last), FluxConfig(), seed,
                    resolution)
    state, before = run.state, {k: p.detach().clone() for k, p in run.state.trainable.items()}
    eager = None
    if graph and eager_steps:
        eager = time_steps(run.step_fn, state, run.batch, run.generator, eager_steps, warmup, profile)
        state = eager.pop("state")
        for key in ("losses", "grad_norm", "skipped_nonfinite", "launches_per_step", "int_mm_per_step"):
            eager.pop(key)
    step, capture_peak = run.step_fn, 0.0
    if graph:  # the graph takes its memory at capture: count the peak of the capture too
        torch.cuda.reset_peak_memory_stats()
        step = jit_train_step(run.step_fn, state, run.batch, run.generator)
        capture_peak = torch.cuda.max_memory_allocated() / 2**30
    timed = time_steps(step, state, run.batch, run.generator, steps, warmup, profile)
    state = timed.pop("state")
    timed["peak_gib"] = max(timed["peak_gib"], capture_peak)
    if graph:
        # a replay runs no wrapper: its launches are the ones the profiler
        # recorded on the card in the profiled replay, beside the capture's
        timed["launches_captured"] = {counter.name: n for counter, n in step.captured_launches.items()}
        device = timed["profile"]["bucket_launches"] if profile else None
        timed["launches_per_step"] = device and {kernel.name: device[kernel.name] for kernel in KERNELS}
        timed["int_mm_per_step"] = device and device["int8_gemm"]
    delta = torch.sqrt(sum((p.detach() - before[k]).float().square().sum() for k, p in state.trainable.items()))

    flops = flux_step_flops(run.arch, 1, (resolution // 16) ** 2, TXT_LEN)
    result = {
        "device": torch.cuda.get_device_name(0),
        "params_b": run.n_params / 1e9,
        "lora_params_m": sum(p.numel() for p in state.trainable.values()) / 1e6,
        "resolution": resolution,
        "batch": 1,
        "remat_policy": remat_policy,
        "skip_last": skip_last,
        # the modes the run used, resolved from its config (bench.py:271-274)
        "quant": run.model.base_precision or "none",
        "quantized_matmul": run.model.quantized_matmul,
        "base_gib": run.base_gib,
        "graph": graph,
        **timed,
        "samples_per_s": 1.0 / timed["s_per_step"],
        "model_tflop_per_step": flops / 1e12,
        "mfu": flops / timed["s_per_step"] / peak_flops(),
        "mfu_median": flops / timed["s_per_step_median"] / peak_flops(),
        "lora_delta": float(delta),
    }
    if eager is not None:
        eager["mfu_median"] = flops / eager["s_per_step_median"] / peak_flops()
        result["eager"] = eager
    del state, step, run, before
    torch.cuda.empty_cache()
    return result


def proxy() -> Dict:
    """The JAX bench's 2.56B proxy (bench.py:276-395): Flux width (3072, 24 x
    128 heads) at depth 4 + 8, batch 4 at 512 px (1024 image + 512 text
    tokens, unmasked), a bf16 base (``BENCH_QUANT`` int8 / fp8 quantizes it),
    rank-16 LoRA, AdamW, no remat unless ``BENCH_REMAT=1``; graphed step,
    ``BENCH_STEPS`` timed after 2 warm-up replays."""
    batch_size = int(os.environ.get("BENCH_BATCH", 4))
    resolution = int(os.environ.get("BENCH_RES", 512))
    steps = int(os.environ.get("BENCH_STEPS", 20))
    remat = os.environ.get("BENCH_REMAT", "0") == "1"
    quant = os.environ.get("BENCH_QUANT") or None
    arch = dataclasses.replace(FluxConfig(), depth_double=4, depth_single=8)
    config = {
        "model_family": "flux", "model_flavour": "dev", "model_type": "lora", "lora_rank": 16,
        "flux_lora_target": "all", "optimizer": "adamw", "learning_rate": 1e-4, "max_train_steps": 1000,
        "mixed_precision": "bf16", "gradient_checkpointing": remat,
        "gradient_checkpointing_policy": os.environ.get("BENCH_REMAT_POLICY", "full"),
        "base_model_precision": f"{quant}-quanto" if quant else "no_change",
    }
    run = build_run(config, arch, seed=0, resolution=resolution, batch_size=batch_size, txt_valid=TXT_LEN,
                    seeded_adapters=False)
    torch.cuda.reset_peak_memory_stats()
    graphed = jit_train_step(run.step_fn, run.state, run.batch, run.generator)
    capture_peak = torch.cuda.max_memory_allocated() / 2**30
    timed = time_steps(graphed, run.state, run.batch, run.generator, steps, 2)
    timed.pop("state")
    flops = flux_step_flops(arch, batch_size, (resolution // 16) ** 2, TXT_LEN)
    result = {
        "device": torch.cuda.get_device_name(0), "params_b": run.n_params / 1e9, "batch": batch_size,
        "resolution": resolution, "remat": remat, "quant": run.model.base_precision or "none",
        "s_per_step": timed["s_per_step"], "s_per_step_median": timed["s_per_step_median"],
        "step_s": timed["step_s"], "samples_per_s": batch_size / timed["s_per_step"],
        "mfu": flops / timed["s_per_step"] / peak_flops(), "mfu_median": flops / timed["s_per_step_median"] / peak_flops(),
        "peak_gib": max(timed["peak_gib"], capture_peak), "losses": timed["losses"],
    }
    del graphed, run
    torch.cuda.empty_cache()
    return result


def result_line(int8: Dict, int4: Dict, proxy_row: Dict, card: str) -> Dict:
    """The bench's last line from its three runs: the int8 flagship's MFU at
    the graphed median step as the value, the rest in ``extra``."""
    row = lambda r: {k: r[k] for k in ("s_per_step_median", "s_per_step", "step_s", "mfu_median", "peak_gib",
                                        "quant")}  # noqa: E731
    return {
        "metric": METRIC,
        "value": int8["mfu_median"],
        "unit": "MFU (fraction of bf16 peak)",
        "extra": {
            "s_per_step_median": int8["s_per_step_median"],
            "s_per_step_mean": int8["s_per_step"],
            "step_s": int8["step_s"],
            "eager_s_per_step_median": int8["eager"]["s_per_step_median"],
            "eager_idle_share": int8["eager"]["profile"]["idle_share_vs_median"],
            "peak_gib": int8["peak_gib"],
            "idle_share": int8["profile"]["idle_share_vs_median"],
            "idle_share_traced": int8["profile"]["idle_share_traced"],
            "device_ms": int8["profile"]["device_ms"],
            "quant": int8["quant"],
            "quantized_matmul": int8["quantized_matmul"],
            "remat_policy": int8["remat_policy"],
            "launches_per_step": int8["launches_per_step"],
            "int_mm_per_step": int8["int_mm_per_step"],
            "flagship_int4": row(int4),
            "proxy_2p56b": {**row(proxy_row), "batch": proxy_row["batch"], "resolution": proxy_row["resolution"]},
            "device": int8["device"],
            "card": card,
        },
    }


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    result = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True)
    return result.stdout.strip().splitlines()[0]


RUNS = (("int8", ["--flagship-only", "int8"]), ("int4", ["--flagship-only", "int4"]), ("proxy", ["--proxy-only"]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m simpletuner_tpu_torch.bench", description=__doc__.split("\n")[0])
    parser.add_argument("--flagship-only", choices=("int8", "int4"), help="run one flagship and print its row")
    parser.add_argument("--proxy-only", action="store_true", help="run the 2.56B proxy and print its row")
    args = parser.parse_args(argv)
    if args.flagship_only:
        steps = int(os.environ.get("BENCH_FLAGSHIP_STEPS", 20))
        # the headline run also times the eager step, for comparison in one process
        eager_steps = steps if args.flagship_only == "int8" else 0
        print(json.dumps(flagship(steps=steps, resolution=int(os.environ.get("BENCH_FLAGSHIP_RES", 1024)),
                                  quant=args.flagship_only, profile=True, eager_steps=eager_steps)), flush=True)
        return 0
    if args.proxy_only:
        print(json.dumps(proxy()), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; the benchmark needs a CUDA device", file=sys.stderr)
        return 2
    rows = {}
    root = Path(__file__).resolve().parents[1]
    for label, flags in RUNS:
        proc = subprocess.run([sys.executable, "-m", "simpletuner_tpu_torch.bench", *flags], cwd=root,
                              capture_output=True, text=True, timeout=1800)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"bench: the {label} run failed with exit code {proc.returncode}:\n{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        rows[label] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{label}: " + json.dumps(rows[label]), file=sys.stderr, flush=True)
    print(json.dumps(result_line(rows["int8"], rows["int4"], rows["proxy"], nvidia_smi())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
