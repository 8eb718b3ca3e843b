"""The torch port's audio data plane against the JAX package, on the CPU.

``data/audio.py`` (a copy: WAV probe and decode with a resample, the
duration buckets, the STFT features of the speech-to-video pairing, the
codec-token readers), audio discovery (``MetadataBackend._discover_audio``:
the buckets and per-file metadata of WAVs and a token file), the VAE cache's
waveform preparation at the file's rate, the 1-D audio VAE (its encode,
draw and decode through bridged params at the tiny config and at ACE-Step's
strides), the trainer's encode function (waveforms staged in f16 under a
bf16 ``vae_dtype``) and its refusal of a mono file where the stereo VAE
takes two channels (the JAX encode raises at the stem conv), and
``_save_wav``'s bytes: the same seeded numpy inputs through both packages.
Forwards are held within 1e-5 relative L2 (f32 on both sides, only the
order of f32 sums differs); host functions exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from simpletuner_tpu.caching.vae_cache import VAECache as JaxVAECache
from simpletuner_tpu.data import audio as jax_audio
from simpletuner_tpu.data.backends.local import LocalDataBackend as JaxLocalDataBackend
from simpletuner_tpu.data.buckets import BucketConfig as JaxBucketConfig
from simpletuner_tpu.data.metadata import MetadataBackend as JaxMetadataBackend
from simpletuner_tpu.models.audio_vae import AudioAutoencoderKL as JaxAudioVAE
from simpletuner_tpu.models.audio_vae import AudioVAEConfig as JaxAudioVAEConfig
from simpletuner_tpu.training.validation import Validation as JaxValidation

from simpletuner_tpu_torch.caching.vae_cache import VAECache
from simpletuner_tpu_torch.data import audio
from simpletuner_tpu_torch.data.backends.local import LocalDataBackend
from simpletuner_tpu_torch.data.buckets import BucketConfig
from simpletuner_tpu_torch.data.metadata import MetadataBackend
from simpletuner_tpu_torch.models.audio_vae import AudioAutoencoderKL, AudioVAEConfig
from simpletuner_tpu_torch.training.trainer import vae_encode_fn
from simpletuner_tpu_torch.training.validation import Validation

from torch_parity import bridge, numpy_variables, rel, t

F32_REL = 1e-5


def write_wav(path, seconds, rate, channels=2, seed=0, dtype=np.int16):
    """A seeded 16-bit (or float) WAV of ``seconds`` at ``rate``."""
    rng = np.random.default_rng(seed)
    shape = (int(round(seconds * rate)), channels) if channels > 1 else (int(round(seconds * rate)),)
    data = rng.standard_normal(shape) * 0.2
    if dtype == np.int16:
        data = (np.clip(data, -1, 1) * 32767).astype(np.int16)
    else:
        data = data.astype(dtype)
    wavfile.write(str(path), rate, data)
    return str(path)


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    """WAVs at 44.1 / 22.05 / 16 kHz, stereo and mono, 16-bit and float, of
    0.4-3.7 s, a codec-token file and a non-WAV container."""
    root = tmp_path_factory.mktemp("audio_files")
    specs = [(2.3, 44100, 2, np.int16), (1.0, 22050, 2, np.int16), (3.7, 16000, 1, np.int16),
             (0.4, 44100, 2, np.float32), (2.9, 8000, 1, np.int16)]
    for i, (seconds, rate, channels, dtype) in enumerate(specs):
        write_wav(root / f"clip_{i}.wav", seconds, rate, channels, seed=i, dtype=dtype)
        (root / f"clip_{i}.txt").write_text(f"song {i}")
    np.save(root / "tokens_0.npy", np.random.default_rng(9).integers(0, 100, (60, 8)))
    (root / "song.mp3").write_bytes(b"not decoded")
    return root


# ---- data/audio.py ----------------------------------------------------------------------------


@pytest.mark.parametrize("seconds,bucket", [(2.4, 1.0), (0.3, 1.0), (47.0, 1.0), (10.0, 5.0), (7.9, 2.5)])
def test_duration_bucket_matches(seconds, bucket):
    assert audio.duration_bucket(seconds, bucket) == jax_audio.duration_bucket(seconds, bucket)


@pytest.mark.parametrize("index,rate,duration,mono", [
    (0, 44100, 1.0, False), (1, 44100, 2.0, False), (2, 16000, None, False), (2, 44100, 1.5, False),
    (3, 22050, 0.2, True), (4, 16000, 3.0, False)])
def test_load_audio_matches(audio_dir, index, rate, duration, mono):
    """Decode, int16 / float scaling, a resample through ``resample_poly``,
    mono mixing, pad and trim: bitwise the JAX module's."""
    path = str(audio_dir / f"clip_{index}.wav")
    ours = audio.load_audio(LocalDataBackend("a", str(audio_dir)), path, rate, duration, mono)
    theirs = jax_audio.load_audio(JaxLocalDataBackend("a", str(audio_dir)), path, rate, duration, mono)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
    assert audio.load_audio(LocalDataBackend("a", str(audio_dir)), str(audio_dir / "song.mp3")) is None


def test_probe_features_and_tokens_match(audio_dir):
    backend, jbackend = LocalDataBackend("a", str(audio_dir)), JaxLocalDataBackend("a", str(audio_dir))
    for name in sorted(os.listdir(audio_dir)):
        path = str(audio_dir / name)
        assert audio.probe_audio(backend, path) == jax_audio.probe_audio(jbackend, path), name
    wave = audio.load_audio(backend, str(audio_dir / "clip_0.wav"), 16000)
    ours, theirs = audio.waveform_features(wave), jax_audio.waveform_features(wave)
    assert ours.shape == theirs.shape and ours.shape[1] == 64
    np.testing.assert_array_equal(ours, theirs)
    tokens = str(audio_dir / "tokens_0.npy")
    np.testing.assert_array_equal(audio.load_token_matrix(backend, tokens),
                                  jax_audio.load_token_matrix(jbackend, tokens))
    assert audio.probe_token_file(backend, tokens, 12.5) == jax_audio.probe_token_file(jbackend, tokens, 12.5)


# ---- discovery and the cache's waveform preparation ----------------------------------------------------


@pytest.mark.parametrize("audio_cfg", [{}, {"bucket_seconds": 0.5, "max_duration": 3.0},
                                       {"token_frame_rate": 20.0}])
def test_discovery_matches(audio_dir, tmp_path, audio_cfg):
    """``_discover_audio``: the bucket index and the per-file metadata (WAVs
    and the token file; the mp3 skipped) equal to the JAX discovery's."""
    kwargs = dict(instance_data_dir=str(audio_dir), dataset_type="audio", video_config=audio_cfg)
    ours = MetadataBackend("a", LocalDataBackend("a", str(audio_dir)), BucketConfig(resolution=1.0),
                           cache_file=str(tmp_path / "p.json"), metadata_file=str(tmp_path / "pm.json"), **kwargs)
    theirs = JaxMetadataBackend("a", JaxLocalDataBackend("a", str(audio_dir)), JaxBucketConfig(resolution=1.0),
                                cache_file=str(tmp_path / "j.json"), metadata_file=str(tmp_path / "jm.json"), **kwargs)
    ours.refresh(max_workers=2)
    theirs.refresh(max_workers=2)
    assert {k: sorted(v) for k, v in ours.aspect_ratio_bucket_indices.items()} == \
        {k: sorted(v) for k, v in theirs.aspect_ratio_bucket_indices.items()}
    assert ours.image_metadata == theirs.image_metadata
    assert len(ours.image_metadata) == 6 and any(m.get("token_file") for m in ours.image_metadata.values())


def test_cache_prepares_waveforms_as_jax(audio_dir, tmp_path):
    """The VAE cache's waveform at the file's own rate, trimmed or padded to
    its bucket's seconds, with the same metadata, bitwise the JAX cache's."""
    backend = LocalDataBackend("a", str(audio_dir))
    jbackend = JaxLocalDataBackend("a", str(audio_dir))
    kwargs = dict(instance_data_dir=str(audio_dir), dataset_type="audio", video_config={"bucket_seconds": 0.5})
    meta = MetadataBackend("a", backend, BucketConfig(resolution=1.0), cache_file=str(tmp_path / "p.json"),
                           metadata_file=str(tmp_path / "pm.json"), **kwargs)
    jmeta = JaxMetadataBackend("a", jbackend, JaxBucketConfig(resolution=1.0), cache_file=str(tmp_path / "j.json"),
                               metadata_file=str(tmp_path / "jm.json"), **kwargs)
    meta.refresh(max_workers=2)
    jmeta.refresh(max_workers=2)
    ours = VAECache("a", backend, meta, str(tmp_path / "vae"))
    theirs = JaxVAECache("a", jbackend, jmeta, str(tmp_path / "jvae"))
    for index in range(5):
        path = str(audio_dir / f"clip_{index}.wav")
        mine, jax_item = ours._prepare_one(path), theirs._prepare_one(path)
        assert mine[0] == jax_item[0] and mine[2] == jax_item[2]
        np.testing.assert_array_equal(mine[1], jax_item[1])
        rate = meta.image_metadata[path]["sample_rate"]
        assert mine[1].shape[0] == int(float(meta.image_metadata[path]["bucket"][:-1]) * rate)


# ---- the 1-D audio VAE ----------------------------------------------------------------------------------

_ACE_STRIDES = AudioVAEConfig(latent_channels=8, base_channels=4, strides=(4, 4, 4, 8), in_channels=2)


@pytest.mark.parametrize("name,config,samples", [("tiny", AudioVAEConfig.tiny(), 400),
                                                 ("ace_strides", _ACE_STRIDES, 44100)])
def test_audio_vae_matches_jax(name, config, samples):
    """Encode (the mean), a draw from the posterior with the JAX clip of the
    log-variance (the noise given to both), and decode through one seeded
    tree, in f32: within ``F32_REL``; the latent length is the JAX one
    (86 latents for a second of 44.1 kHz at ACE-Step's strides)."""
    jconfig = JaxAudioVAEConfig(**{f: getattr(config, f) for f in
                                   ("latent_channels", "base_channels", "strides", "in_channels")})
    jvae = JaxAudioVAE(jconfig, dtype=jnp.float32)
    x = np.random.default_rng(3).uniform(-0.8, 0.8, (2, samples, config.in_channels)).astype(np.float32)
    variables = numpy_variables(jvae, x[:, :64 * config.compression], seed=4)
    vae = bridge(variables, AudioAutoencoderKL(config, torch.float32))
    mean = vae.encode(t(x), sample=False).detach().numpy()
    ref = np.asarray(jvae.apply(variables, x, method=JaxAudioVAE.encode, sample=False))
    assert mean.shape == ref.shape and rel(mean, ref) < F32_REL
    if name == "ace_strides":
        assert mean.shape == (2, 86, 8)
    out = vae.decode(t(ref)).detach().numpy()
    jout = np.asarray(jvae.apply(variables, ref, method=JaxAudioVAE.decode))
    assert out.dtype == np.float32 and out.shape == jout.shape == (2, ref.shape[1] * config.compression,
                                                                    config.in_channels)
    assert rel(out, jout) < F32_REL
    # the posterior draw: the JAX draw's noise, recomputed from its key, given to both
    key = jax.random.PRNGKey(5)
    jdraw = np.asarray(jvae.apply(variables, x, key, method=JaxAudioVAE.encode))
    noise = np.asarray(jax.random.normal(key, ref.shape, jnp.float32))
    gen = torch.Generator().manual_seed(0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "randn", lambda shape, generator=None, dtype=None, device=None: t(noise))
        draw = vae.encode(t(x), generator=gen).detach().numpy()
    assert rel(draw, jdraw) < F32_REL and rel(draw, ref) > 1e-3


def test_cpu_bf16_conv1d_is_wrong_where_the_strided_conv_unfolds():
    """torch's CPU ``conv1d`` in bf16 at a strided even-kernel shape of the
    encoder (8 -> 16 channels, kernel 8, stride 4, padding 2) lands far from
    the float64 convolution of the same bf16 values, which is why ``_strided``
    takes ``unfolded_conv`` for a bf16 input on the CPU; the product agrees
    within a bf16 rounding (2^-8), and an f32 input goes through ``conv1d``.
    When this torch's ``conv1d`` is right here, the workaround can go."""
    from simpletuner_tpu_torch.models.audio_vae import _conv, _strided, unfolded_conv

    rng = np.random.default_rng(11)
    conv = _conv(8, 16, 8, torch.bfloat16, stride=4, padding=2)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(rng.standard_normal((16, 8, 8)) * 0.2))
        conv.bias.copy_(torch.tensor(rng.standard_normal(16) * 0.1))
    x = torch.tensor(rng.standard_normal((2, 8, 320)), dtype=torch.bfloat16)
    exact = torch.nn.functional.conv1d(x.double(), conv.weight.double(), conv.bias.double(), stride=4, padding=2)
    with torch.no_grad():
        assert rel(conv(x).double().numpy(), exact.numpy()) > 0.5  # the fault
        assert rel(unfolded_conv(conv, x).double().numpy(), exact.numpy()) < 2 ** -8
        assert torch.equal(_strided(conv, x), unfolded_conv(conv, x))
        x32, conv32 = x.float(), conv.float()
        assert torch.equal(_strided(conv32, x32), conv32(x32))
        assert rel(conv32(x32).double().numpy(), exact.numpy()) < F32_REL


def test_audio_vae_draw_uses_the_generator():
    vae = AudioAutoencoderKL(AudioVAEConfig.tiny(), torch.float32)
    from simpletuner_tpu_torch.models.layers import init_parameters

    init_parameters(vae, torch.Generator().manual_seed(0))
    x = torch.rand((1, 256, 1))
    first = vae.encode(x, torch.Generator().manual_seed(1))
    again = vae.encode(x, torch.Generator().manual_seed(1))
    other = vae.encode(x, torch.Generator().manual_seed(2))
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert torch.equal(vae.encode(x), vae.encode(x, sample=True))  # no generator: the mean
    assert vae.decode(vae.encode(x)).shape == (1, 256, 1)


def test_trainer_encode_stages_waveforms_in_f16():
    """Under a bf16 ``vae_dtype`` the JAX trainer stages waveforms in f16
    before its encode; the port's encode function does too, and gives the
    f32 latents of the bf16 module."""
    config = AudioVAEConfig(latent_channels=4, base_channels=8, strides=(4, 4), in_channels=2)
    jconfig = JaxAudioVAEConfig(latent_channels=4, base_channels=8, strides=(4, 4), in_channels=2)
    jvae = JaxAudioVAE(jconfig)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 320, 2)).astype(np.float32)
    variables = numpy_variables(jvae, x, seed=7)
    vae = bridge(variables, AudioAutoencoderKL(config))
    latents = vae_encode_fn(vae, torch.device("cpu"), torch.float16)(x, 2)
    assert latents.dtype == torch.float32 and latents.shape == (2, 20, 4)
    staged = np.asarray(x, np.float16)
    ref = np.asarray(jvae.apply(variables, jnp.asarray(staged).astype(jnp.float32),
                                method=JaxAudioVAE.encode)).astype(np.float32)
    # bf16 convolutions on both sides (XLA and torch round their products
    # and sums differently): within a bf16 rounding of the f32 values
    assert rel(latents.numpy(), ref) < 2e-2
    np.testing.assert_array_equal(vae_encode_fn(vae, torch.device("cpu"), torch.float16)(x, 2).numpy(),
                                  vae.encode(torch.from_numpy(staged).float()).float().detach().numpy())


def test_mono_file_is_refused_as_jax_raises():
    """A mono batch at the stereo VAE (``AudioVAEConfig.ace()`` takes two
    channels): the JAX encode raises at the stem conv's shape check; the
    port's encode function refuses it by name."""
    jvae = JaxAudioVAE(JaxAudioVAEConfig(latent_channels=4, base_channels=4, strides=(4, 4), in_channels=2))
    stereo = np.zeros((1, 64, 2), np.float32)
    variables = numpy_variables(jvae, stereo, seed=1)
    mono = np.zeros((1, 64, 1), np.float32)
    with pytest.raises(Exception):
        jvae.apply(variables, mono, method=JaxAudioVAE.encode)
    vae = bridge(variables, AudioAutoencoderKL(AudioVAEConfig(latent_channels=4, base_channels=4, strides=(4, 4),
                                                              in_channels=2)))
    with pytest.raises(ValueError, match="mono file"):
        vae_encode_fn(vae, torch.device("cpu"), torch.float16)(mono, 1)
    assert AudioVAEConfig.ace().in_channels == JaxAudioVAEConfig.ace().in_channels == 2


# ---- the WAV writer ---------------------------------------------------------------------------------------


def test_save_wav_bytes_match(tmp_path):
    """``_save_wav``: clipped to [-1, 1], x 32767, truncated to int16; the
    file byte for byte the JAX writer's, mono and stereo, at two rates."""
    rng = np.random.default_rng(8)
    for channels, rate in ((2, 44100), (1, 16000)):
        wave = rng.uniform(-1.4, 1.4, (1000, channels)).astype(np.float32)
        Validation._save_wav(wave, str(tmp_path / "p.wav"), rate)
        JaxValidation._save_wav(wave, str(tmp_path / "j.wav"), rate)
        assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
        read_rate, data = wavfile.read(str(tmp_path / "p.wav"))
        assert read_rate == rate and data.dtype == np.int16 and data.reshape(1000, -1).shape == (1000, channels)
