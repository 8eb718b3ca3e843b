"""The torch port's Cosmos3 AVAE audio tokenizer against the JAX package, on
the CPU.

The configs (the shipped one's 496M parameters, encoder and decoder, as the
JAX ``eval_shape``); log-scale SnakeBeta; ``stft_features`` (and against
``torch.stft`` on the padded wave); the transposed conv at odd and even
strides; a ConvNeXt block and a residual unit; encode (the posterior mode,
with the batch-wide volume normalisation on a batch of two different peaks
and the pad to ``hop_size``) and decode (clamped), and a draw with a
generator against the JAX moments; the weight-norm fold and the importer
bitwise the JAX one, its refusal of a decoder-only file, and
``Cosmos3.load_sound_tokenizer``.  Every tolerance is stated where it is
checked.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from safetensors.numpy import save_file as np_save_file

from simpletuner_tpu.models.cosmos3 import audio_tokenizer as jat
from simpletuner_tpu.models.cosmos3.model import Cosmos3 as JaxCosmos3

from simpletuner_tpu_torch.models.cosmos3 import Cosmos3
from simpletuner_tpu_torch.models.cosmos3 import audio_tokenizer as tat

from test_torch_weight_import import _assert_trees_bitwise
from torch_parity import bridge, numpy_variables, rel, t

# f32 on both sides: only the order of f32 sums (convolutions, FFTs) differs
F32_REL = 1e-5


def _wave(seed, batch=2, channels=2, samples=150, peaks=(0.4, 2.5)):
    """A seeded waveform whose samples peak at different heights."""
    rng = np.random.default_rng(seed)
    wave = rng.standard_normal((batch, channels, samples)).astype(np.float32)
    for i, peak in enumerate(peaks[:batch]):
        wave[i] *= peak / np.abs(wave[i]).max()
    return wave


@pytest.fixture(scope="module")
def tokenizer():
    """The JAX tiny tokenizer's seeded variables and the port module that holds them."""
    cfg = jat.Cosmos3AudioTokenizerConfig.tiny()
    jmodule = jat.Cosmos3AudioTokenizer(cfg)
    variables = numpy_variables(jmodule, jnp.asarray(_wave(0, samples=64)), seed=1)
    port = bridge(variables, tat.Cosmos3AudioTokenizer(tat.Cosmos3AudioTokenizerConfig.tiny()))
    return jmodule, variables, port


def test_configs_match_jax():
    """Both presets equal the JAX ones; the shipped tokenizer holds 496M
    parameters (encoder 23M, decoder 473M) as the JAX ``eval_shape`` counts
    them; ``hop_size`` 1920 (250 latent frames for 10 s at 48 kHz)."""
    for ours, theirs in ((tat.Cosmos3AudioTokenizerConfig.tiny(), jat.Cosmos3AudioTokenizerConfig.tiny()),
                         (tat.Cosmos3AudioTokenizerConfig(), jat.Cosmos3AudioTokenizerConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.hop_size == theirs.hop_size and ours.audio_channels == theirs.audio_channels
    cfg = tat.Cosmos3AudioTokenizerConfig()
    assert cfg.hop_size == 1920 and 480_000 // cfg.hop_size == 250
    with torch.device("meta"):
        port = tat.Cosmos3AudioTokenizer(cfg)
    counts = {name: sum(p.numel() for p in getattr(port, name).parameters()) for name in ("encoder", "decoder")}
    tree = jax.eval_shape(lambda: jat.Cosmos3AudioTokenizer(jat.Cosmos3AudioTokenizerConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 3840))))["params"]
    for name in ("encoder", "decoder"):
        assert counts[name] == sum(math.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree[name])), name
    assert round(counts["encoder"] / 1e6) == 23 and round(counts["decoder"] / 1e6) == 473


def test_snake_and_stft_match_jax():
    """SnakeBeta with seeded log-scale alpha / beta within ``F32_REL``;
    ``stft_features`` (n_fft 64, hop 16, and the tiny 16 / 4) within
    ``F32_REL`` of the JAX features and of ``torch.stft`` on the padded wave
    (periodic hann, ``center=False``)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 40)).astype(np.float32)
    alpha, beta = (rng.standard_normal(6).astype(np.float32) * 0.5 for _ in range(2))
    ours = tat.snake_beta(t(x), t(alpha), t(beta)).numpy()
    theirs = jat.snake_beta(jnp.asarray(x.transpose(0, 2, 1)), jnp.asarray(alpha), jnp.asarray(beta))
    assert rel(ours, np.asarray(theirs).transpose(0, 2, 1)) < F32_REL
    wave = rng.standard_normal((3, 1000)).astype(np.float32)
    for n_fft, hop in ((64, 16), (16, 4)):
        ours = tat.stft_features(t(wave), n_fft, hop)
        theirs = np.asarray(jat.stft_features(jnp.asarray(wave), n_fft, hop))
        assert ours.shape == theirs.shape == (3, 1 + (1000 - hop) // hop, n_fft + 2)
        assert rel(ours.numpy(), theirs) < F32_REL
        left = (n_fft - hop) // 2
        padded = F.pad(t(wave), (left, n_fft - hop - left))
        spec = torch.stft(padded, n_fft, hop, window=torch.hann_window(n_fft), center=False,
                          return_complex=True).transpose(1, 2)
        assert rel(ours.numpy(), torch.cat([spec.real, spec.imag], -1).numpy()) < F32_REL


@pytest.mark.parametrize("stride", [2, 3, 4, 5])
def test_conv_transpose_matches_jax(stride):
    """The transposed conv (k = 2s, pad ceil(s/2), output_padding s % 2) at
    odd and even strides: the output length and values within ``F32_REL`` of
    the JAX lhs-dilated conv over its (k, in, out) kernel."""
    rng = np.random.default_rng(3 + stride)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)  # (B, T, C) for JAX
    args = dict(in_channels=6, out_channels=4, kernel_size=2 * stride, stride=stride,
                padding=math.ceil(stride / 2), output_padding=stride % 2)
    jconv = jat.ConvTranspose1d(**args)
    variables = numpy_variables(jconv, jnp.asarray(x), seed=4)
    ref = np.asarray(jconv.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x))).transpose(0, 2, 1)
    port = bridge(variables, tat.ConvTranspose1d(*args.values()))
    with torch.no_grad():
        out = port(t(x.transpose(0, 2, 1))).numpy()
    assert out.shape == ref.shape == (2, 4, 9 * stride) and rel(out, ref) < F32_REL


def test_convnext_block_and_residual_unit_match_jax():
    """A ConvNeXt block (SnakeBeta and the exact-gelu variant) and a residual
    unit at dilations 1 / 3 / 9 within ``F32_REL`` of the JAX modules."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 30, 8)).astype(np.float32)
    cases = [(jat.ConvNeXtBlock(8, True), tat.ConvNeXtBlock(8, True)),
             (jat.ConvNeXtBlock(8, False), tat.ConvNeXtBlock(8, False))]
    cases += [(jat.ResidualUnit(8, d), tat.ResidualUnit(8, d)) for d in (1, 3, 9)]
    for seed, (jmod, port_mod) in enumerate(cases):
        variables = numpy_variables(jmod, jnp.asarray(x), seed=seed)
        ref = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x)))
        port = bridge(variables, port_mod)
        with torch.no_grad():
            out = port(t(x.transpose(0, 2, 1))).numpy()
        assert rel(out, ref.transpose(0, 2, 1)) < F32_REL, seed


def test_encode_and_decode_match_jax(tokenizer):
    """Encode (the posterior mode) of a batch of two waveforms with peaks 0.4
    and 2.5 and 150 samples (padded to 160, a multiple of ``hop_size`` 16):
    the batch is normalised by its one peak (2.5), not each sample by its
    own, in both packages; latents and the clamped decode within
    ``F32_REL``; a draw with a generator is the mode plus (softplus(scale) +
    1e-4) times the generator's normal noise, from the JAX moments."""
    jmodule, variables, port = tokenizer
    wave = _wave(6)
    params = jax.tree_util.tree_map(jnp.asarray, variables)
    encode = jax.jit(lambda p, x: jmodule.apply(p, x, method=jmodule.encode))
    ref = np.asarray(encode(params, jnp.asarray(wave)))
    with torch.no_grad():
        latents = port.encode(t(wave))
    assert latents.shape == ref.shape == (2, 4, 10) and rel(latents.numpy(), ref) < F32_REL
    alone = np.asarray(encode(params, jnp.asarray(wave[:1])))
    with torch.no_grad():
        port_alone = port.encode(t(wave[:1]))
    assert rel(port_alone.numpy(), alone) < F32_REL and not np.allclose(alone, ref[:1], atol=1e-3)
    decoded_ref = np.asarray(jax.jit(lambda p, z: jmodule.apply(p, z, method=jmodule.decode))(params, jnp.asarray(ref)))
    with torch.no_grad():
        decoded = port.decode(t(ref))
    assert decoded.shape == decoded_ref.shape == (2, 2, 160) and rel(decoded.numpy(), decoded_ref) < F32_REL
    assert float(decoded.abs().max()) <= 1.0
    scaled = jnp.pad(jnp.asarray(wave) / (np.abs(wave).max() + 1e-5) * 0.95, ((0, 0), (0, 0), (0, 10)))
    moments = np.asarray(jax.jit(lambda p, x: jmodule.apply(p, x, method=lambda m, y: m.encoder(y)))(
        params, scaled)).transpose(0, 2, 1)
    mean, scale = moments[:, :4], moments[:, 4:]
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        drawn = port.encode(t(wave), generator=torch.Generator().manual_seed(9))
    expected = mean + (np.logaddexp(0.0, scale) + 1e-4) * noise.numpy()
    assert rel(drawn.numpy(), expected) < F32_REL


def _reference_state_dict(variables, cfg, seed):
    """A ``Cosmos3AVAEAudioTokenizer`` state dict of the JAX tree's shapes:
    every other conv weight-normed (``weight_g`` / ``weight_v``), the
    transposed convs (I, O, k), the snake parameters (1, C, 1)."""
    rng = np.random.default_rng(seed)
    w, counter = {}, iter(range(10_000))

    def conv(key, kernel, transposed=False, bias=None):
        shape = kernel.shape[::-1] if not transposed else (kernel.shape[1], kernel.shape[2], kernel.shape[0])
        if next(counter) % 2:
            w[f"{key}.weight_v"] = rng.standard_normal(shape).astype(np.float32)
            w[f"{key}.weight_g"] = rng.uniform(0.5, 1.5, (shape[0], 1, 1)).astype(np.float32)
        else:
            w[f"{key}.weight"] = rng.standard_normal(shape).astype(np.float32)
        if bias is not None:
            w[f"{key}.bias"] = rng.standard_normal(bias.shape).astype(np.float32)

    def snake(key, alpha):
        for leaf in ("alpha", "beta"):
            w[f"{key}.{leaf}"] = rng.standard_normal((1, alpha.shape[0], 1)).astype(np.float32)

    enc, dec = variables["params"]["encoder"], variables["params"]["decoder"]
    for i in range(len(enc)):
        node, src = enc[f"layer_{i}"], f"encoder.layers.{i}"
        if "dwconv" in node:
            conv(f"{src}.dwconv.1", node["dwconv"]["kernel"], bias=node["dwconv"]["bias"])
            w[f"{src}.norm.weight"] = rng.standard_normal(node["norm_scale"].shape).astype(np.float32)
            for name in ("pwconv1", "pwconv2"):
                conv(f"{src}.{name}", node[name]["kernel"], bias=node[name]["bias"])
            snake(f"{src}.act", node["act_alpha"])
        else:
            conv(src, node["kernel"], bias=node.get("bias"))
    conv("decoder.conv1", dec["conv1"]["kernel"], bias=dec["conv1"]["bias"])
    conv("decoder.conv2", dec["conv2"]["kernel"])
    snake("decoder.snake1", dec["snake_out_alpha"])
    for i in range(len(cfg.dec_strides)):
        src = f"decoder.block.{i}"
        snake(f"{src}.snake1", dec[f"block_{i}_snake_alpha"])
        conv(f"{src}.conv_t1", dec[f"block_{i}_convt"]["kernel"], transposed=True, bias=dec[f"block_{i}_convt"]["bias"])
        for j in range(3):
            node, unit = dec[f"block_{i}_res_{j}"], f"{src}.res_unit{j + 1}"
            for name in ("conv1", "conv2"):
                conv(f"{unit}.{name}", node[name]["kernel"], bias=node[name]["bias"])
            snake(f"{unit}.snake1", node["snake1_alpha"])
            snake(f"{unit}.snake2", node["snake2_alpha"])
    return w


def test_weight_norm_import_and_load_sound_tokenizer_match_jax(tmp_path, tokenizer):
    """A reference-layout file (half its convs weight-normed): the port's
    tree bitwise the JAX ``load_cosmos3_audio_tokenizer`` tree (the fold in
    numpy f32 on both sides); ``Cosmos3.load_sound_tokenizer`` on the CPU
    decodes within ``F32_REL`` of the JAX family's loader; a decoder-only
    file is refused by both."""
    jmodule, variables, _ = tokenizer
    cfg = jat.Cosmos3AudioTokenizerConfig.tiny()
    weights = _reference_state_dict(variables, cfg, seed=7)
    assert any(k.endswith("conv_t1.weight_g") for k in weights) and any(k.endswith("weight_v") for k in weights)
    path = str(tmp_path / "avae.safetensors")
    np_save_file(weights, path)
    theirs = jat.load_cosmos3_audio_tokenizer(cfg, path)
    _assert_trees_bitwise(tat.load_cosmos3_audio_tokenizer(tat.Cosmos3AudioTokenizerConfig.tiny(), path), theirs)
    module = Cosmos3.load_sound_tokenizer(path, tiny=True, device="cpu")
    jmod, jvars = JaxCosmos3.load_sound_tokenizer(path, tiny=True)
    latents = np.random.default_rng(8).standard_normal((1, 4, 6)).astype(np.float32)
    ref = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, jvars), jnp.asarray(latents), method=jmod.decode))
    with torch.no_grad():
        out = module.decode(t(latents)).numpy()
    assert out.shape == ref.shape and rel(out, ref) < F32_REL
    decoder_only = str(tmp_path / "decoder.safetensors")
    np_save_file({k: v for k, v in weights.items() if k.startswith("decoder.")}, decoder_only)
    for load in (jat.load_cosmos3_audio_tokenizer, tat.load_cosmos3_audio_tokenizer):
        with pytest.raises(ValueError, match="decoder-only"):
            load(cfg, decoder_only)
