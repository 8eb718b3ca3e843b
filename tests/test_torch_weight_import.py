"""The torch port's pretrained-weight import against the JAX package's, on the CPU.

Seeded numpy checkpoints of tiny Flux in the diffusers and BFL layouts
(single file and sharded, f32 and bf16) and of the tiny VAE (both mid
attention layouts), written with ``safetensors.numpy``, go through the JAX
importers and the port's.  The trees must agree leaf for leaf, bitwise; the
module the port fills from the file must equal, bitwise, the one bridged
from the JAX tree; a forward pass matches the JAX module's within f32 sum
order.  The port's own safetensors reader and writer are held against the
``safetensors`` package for every dtype they take.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from simpletuner_tpu.models.vae import VAEConfig as JaxVAEConfig
from simpletuner_tpu.models.weight_import import load_flux_params as jax_load_flux_params
from simpletuner_tpu.models.weight_import import load_vae_params as jax_load_vae_params

from simpletuner_tpu_torch.inference import config_namespace
from simpletuner_tpu_torch.models.checkpoint_layouts import (
    flux_bfl_from_diffusers,
    flux_checkpoint_shapes,
    vae_checkpoint_shapes,
)
from simpletuner_tpu_torch.models.flux import Flux
from simpletuner_tpu_torch.models.layers import init_adapters
from simpletuner_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from simpletuner_tpu_torch.models.vae_import import load_vae_params
from simpletuner_tpu_torch.models.weight_bridge import load_flax_params
from simpletuner_tpu_torch.models.weight_import import (
    load_flux_params,
    load_safetensors_file,
    load_transformer_params,
    read_safetensors,
    save_safetensors,
)

from torch_parity import rel


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _numpy(leaf):
    return leaf.to(torch.float32).numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf, np.float32)


def _assert_trees_bitwise(ours, theirs):
    ours, theirs = dict(_flat(ours)), dict(_flat(theirs))
    assert sorted(ours) == sorted(theirs)
    for path in theirs:
        a, b = _numpy(ours[path]), _numpy(theirs[path])
        assert a.shape == b.shape and np.array_equal(a, b), path


def _seeded(shapes, seed, dtype):
    """numpy checkpoint tensors: N(0, 1/fan_in) matrices, 1 + N(0, 0.1) norm weights, N(0, 0.1) biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        draw = rng.standard_normal(shape).astype(np.float32)
        if len(shape) > 1:
            draw /= np.sqrt(np.prod(shape[1:]))
        elif name.endswith(".weight"):
            draw = 1.0 + 0.1 * draw
        else:
            draw = 0.1 * draw
        out[name] = draw.astype(ml_dtypes.bfloat16) if dtype == "bf16" else draw
    return out


def _config(precision="bf16", **extra):
    return config_namespace({"model_family": "flux", "model_arch_preset": "tiny", "model_type": "lora",
                             "lora_rank": 4, "mixed_precision": precision, **extra})


def _to_torch(array):
    if array.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(array.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(array.copy())


def _to_numpy(tensor):
    if tensor.dtype == torch.bfloat16:
        return tensor.contiguous().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return tensor.contiguous().numpy()


def _write(weights, tmp_path, layout, sharded):
    """The checkpoint as one file, or as two shards in a diffusers ``transformer/`` dir (BFL: a plain dir)."""
    if layout == "bfl":
        bfl = flux_bfl_from_diffusers({k: _to_torch(v) for k, v in weights.items()})
        weights = {k: _to_numpy(v) for k, v in bfl.items()}
    if not sharded:
        path = str(tmp_path / f"{layout}.safetensors")
        np_save_file(weights, path)
        return path
    root = tmp_path / layout
    shard_dir = root / "transformer" if layout == "diffusers" else root
    shard_dir.mkdir(parents=True)
    names = sorted(weights)
    for i, part in enumerate((names[::2], names[1::2])):
        np_save_file({k: weights[k] for k in part}, str(shard_dir / f"model-0000{i + 1}-of-00002.safetensors"))
    return str(root)


@pytest.fixture(scope="module")
def flux_models():
    from simpletuner_tpu.models import layers as jl

    previous = jl._LORA_TARGET
    try:
        jmodel = JaxFlux(_config())
    finally:
        jl.set_lora_target(previous)
    return jmodel, Flux(_config())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sharded", [False, True], ids=["file", "shards"])
@pytest.mark.parametrize("layout", ["bfl", "diffusers"])
def test_flux_import_matches_jax_bitwise(tmp_path, flux_models, layout, sharded, dtype):
    jmodel, model = flux_models
    weights = _seeded(flux_checkpoint_shapes(model.arch), seed=1, dtype=dtype)
    path = _write(weights, tmp_path, layout, sharded)
    jax_tree = jax_load_flux_params(jmodel, path)
    _assert_trees_bitwise(load_flux_params(model, path), jax_tree)

    # the module filled from the file == the module bridged from the JAX tree, base tensors bitwise
    imported = load_transformer_params(model, init_adapters(model.create_module()), path)
    bridged = load_flax_params(init_adapters(model.create_module()), jax_tree, keep_adapters=True)
    ours, theirs = imported.state_dict(), bridged.state_dict()
    base = [k for k in theirs if not k.endswith(("lora_A", "lora_B"))]
    assert base and all(torch.equal(ours[k], theirs[k]) for k in base)
    assert ours["img_in.weight"].dtype == torch.bfloat16  # the module's dtype, whatever the file's


@pytest.mark.parametrize("layout", ["bfl", "diffusers"])
def test_fp8_file_imports_its_values_without_an_f32_copy(tmp_path, flux_models, layout):
    """An F8_E4M3 checkpoint (the published fp8 files' dtype; the JAX reader
    cannot open one) imports as the f32 file of the same values does, bitwise,
    in bf16 and f32 modules; its leaves reach the bridge as the file's e4m3
    bytes, not as an f32 (or any) copy, and the bridge takes them to the
    module's dtype, which holds every e4m3 value exactly."""
    _, model = flux_models
    fp8 = {k: _to_torch(v).to(torch.float8_e4m3fn)
           for k, v in _seeded(flux_checkpoint_shapes(model.arch), seed=6, dtype="f32").items()}
    as_f32 = {k: v.float().numpy() for k, v in fp8.items()}
    if layout == "bfl":
        fp8, as_f32 = flux_bfl_from_diffusers(fp8), flux_bfl_from_diffusers({k: torch.from_numpy(v)
                                                                             for k, v in as_f32.items()})
    save_safetensors(fp8, str(tmp_path / "fp8.safetensors"))
    save_safetensors(as_f32, str(tmp_path / "f32.safetensors"))
    tree = load_flux_params(model, str(tmp_path / "fp8.safetensors"))
    assert {leaf.dtype for _, leaf in _flat(tree)} == {torch.float8_e4m3fn}
    for precision in ("bf16", "fp32"):
        target = Flux(_config(precision))
        a = load_transformer_params(target, init_adapters(target.create_module()), str(tmp_path / "fp8.safetensors"))
        b = load_transformer_params(target, init_adapters(target.create_module()), str(tmp_path / "f32.safetensors"))
        ours, theirs = a.state_dict(), b.state_dict()
        base = [k for k in theirs if not k.endswith(("lora_A", "lora_B"))]
        assert base and all(torch.equal(ours[k], theirs[k]) for k in base), precision


@pytest.mark.parametrize("layout", ["bfl", "diffusers"])
def test_imported_flux_forward_matches_jax(tmp_path, flux_models, layout):
    """An f32 module from the file against the JAX module on the JAX import of the same file."""
    from simpletuner_tpu.models import layers as jl

    weights = _seeded(flux_checkpoint_shapes(flux_models[1].arch), seed=2, dtype="f32")
    path = _write(weights, tmp_path, layout, sharded=False)
    previous = jl._LORA_TARGET
    try:
        jmodel = JaxFlux(_config("fp32", model_type="full"))
    finally:
        jl.set_lora_target(previous)
    model = Flux(_config("fp32", model_type="full"))
    module = load_transformer_params(model, model.create_module(), path)
    rng = np.random.default_rng(3)
    inputs = {
        "img": rng.standard_normal((1, 16, 16), dtype=np.float32),
        "img_ids": np.zeros((1, 16, 3), np.int32) + np.arange(16)[None, :, None].astype(np.int32),
        "txt": rng.standard_normal((1, 12, 32), dtype=np.float32),
        "txt_ids": np.zeros((1, 12, 3), np.int32),
        "timesteps": np.asarray([0.4], np.float32),
        "vec": rng.standard_normal((1, 32), dtype=np.float32),
        "guidance": np.asarray([3.5], np.float32),
    }
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, jax_load_flux_params(jmodel, path))}
    ref = np.asarray(jmodel.module.apply(variables, **{k: jnp.asarray(v) for k, v in inputs.items()}))
    with torch.no_grad():
        out = module(**{k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    assert rel(out, ref) < 1e-5  # f32 on both sides: sum order only


@pytest.mark.parametrize("legacy", [False, True], ids=["linear_attention", "conv1x1_attention"])
def test_vae_import_matches_jax_bitwise(tmp_path, legacy):
    vae = AutoencoderKL(VAEConfig.tiny())
    weights = _seeded(vae_checkpoint_shapes(vae, legacy_attention=legacy), seed=4, dtype="f32")
    (tmp_path / "model" / "vae").mkdir(parents=True)
    np_save_file(weights, str(tmp_path / "model" / "vae" / "diffusion_pytorch_model.safetensors"))
    path = str(tmp_path / "model")  # the vae/ subfolder is found on both sides
    jvae = JaxAutoencoderKL(JaxVAEConfig.tiny())
    jax_tree = jax_load_vae_params(jvae, path)["params"]
    tree = load_vae_params(vae, path)["params"]
    _assert_trees_bitwise(tree, jax.tree_util.tree_map(np.asarray, jax_tree))
    load_flax_params(vae, tree)
    bridged = load_flax_params(AutoencoderKL(VAEConfig.tiny()), jax.tree_util.tree_map(np.asarray, jax_tree))
    assert all(torch.equal(a, b) for a, b in zip(vae.state_dict().values(), bridged.state_dict().values()))
    image = np.random.default_rng(5).uniform(-1, 1, (1, 16, 24, 3)).astype(np.float32)
    ref = np.asarray(jvae.apply({"params": jax_tree}, jnp.asarray(image), method=JaxAutoencoderKL.encode))
    with torch.no_grad():
        assert rel(vae.encode(torch.from_numpy(image)).numpy(), ref) < 1e-5  # f32 convs: sum order only


def test_vae_without_quant_convs_is_refused(tmp_path):
    """FLUX.1-dev's published VAE has no quant_conv / post_quant_conv: the JAX
    import leaves both out of its tree, and the port refuses the file by name
    (ROADMAP Queue 3) where its bridge would stop on the missing tensors."""
    from simpletuner_tpu_torch.training.trainer import Trainer

    shapes = vae_checkpoint_shapes(AutoencoderKL(VAEConfig.tiny()))
    published = {k: v for k, v in shapes.items() if not k.startswith(("quant_conv.", "post_quant_conv."))}
    assert len(published) == len(shapes) - 4
    (tmp_path / "flux" / "vae").mkdir(parents=True)
    np_save_file(_seeded(published, seed=8, dtype="f32"),
                 str(tmp_path / "flux" / "vae" / "diffusion_pytorch_model.safetensors"))
    path = str(tmp_path / "flux")
    jax_tree = jax_load_vae_params(JaxAutoencoderKL(JaxVAEConfig.tiny()), path)["params"]
    assert "quant_conv" not in jax_tree and "post_quant_conv" not in jax_tree and "encoder" in jax_tree
    with pytest.raises(NotImplementedError, match="quant_conv / post_quant_conv.*ROADMAP Queue 3"):
        load_vae_params(AutoencoderKL(VAEConfig.tiny()), path)
    config = _config(pretrained_model_name_or_path=path)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 3"):
        Trainer(Flux(config), config, device="cpu")._init_vae(tiny=True)


_ALL_DTYPES = [torch.float32,torch.float16, torch.bfloat16, torch.float8_e4m3fn, torch.int8, torch.uint8,
               torch.int32, torch.int64]


def _tensors(dtype):
    gen = torch.Generator().manual_seed(6)
    draw = torch.randn((3, 5, 2), generator=gen) * 4
    shapes = {"matrix": draw, "scalar": draw[0, 0, 0], "empty": draw[:0], "vector": draw[1, :, 0]}
    return {name: value.to(dtype).clone() for name, value in shapes.items()}


@pytest.mark.parametrize("dtype", _ALL_DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_safetensors_io_matches_the_package(tmp_path, dtype):
    tensors = _tensors(dtype)
    ours, theirs = str(tmp_path / "ours.safetensors"), str(tmp_path / "theirs.safetensors")
    save_safetensors(tensors, ours, metadata={"format": "pt", "rank": 4})
    torch_save_file(tensors, theirs, metadata={"format": "pt", "rank": "4"})
    for written in (ours, theirs):
        for reader in (load_safetensors_file, torch_load_file):
            loaded = reader(written)
            assert sorted(loaded) == sorted(tensors)
            for name, value in tensors.items():
                assert loaded[name].dtype == dtype and loaded[name].shape == value.shape
                assert torch.equal(loaded[name].reshape(-1).view(torch.uint8), value.reshape(-1).view(torch.uint8)), name
        with safe_open(written, framework="pt") as handle:
            assert handle.metadata() == {"format": "pt", "rank": "4"}
    # loaded tensors are writable copy-on-write views: the file stays as written
    before = open(ours, "rb").read()
    load_safetensors_file(ours)["matrix"].zero_()
    assert open(ours, "rb").read() == before


def test_read_safetensors_directory_rules(tmp_path):
    np_save_file({"a": np.ones(2, np.float32)}, str(tmp_path / "top.safetensors"))
    (tmp_path / "transformer").mkdir()
    np_save_file({"b": np.zeros(3, np.float32)}, str(tmp_path / "transformer" / "x.safetensors"))
    assert sorted(read_safetensors(str(tmp_path))) == ["b"]  # transformer/ is preferred
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        read_safetensors(str(tmp_path / "empty"))
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes((10**6).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError):
        load_safetensors_file(str(bad))


def test_only_flux_imports(tmp_path):
    class DeepFloyd:
        NAME = "deepfloyd"

    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        load_transformer_params(DeepFloyd(), torch.nn.Linear(1, 1), str(tmp_path))


def test_trainer_loads_a_pretrained_checkpoint(tmp_path, flux_models):
    """init_load_base_model imports the file (adapters drawn fresh, B = 0);
    a missing path refuses unless untrained weights are allowed."""
    from simpletuner_tpu_torch.training.trainer import Trainer

    model = flux_models[1]
    weights = _seeded(flux_checkpoint_shapes(model.arch), seed=7, dtype="bf16")
    path = _write(weights, tmp_path, "diffusers", sharded=True)
    trainer = Trainer(Flux(_config(pretrained_model_name_or_path=path)), _config(pretrained_model_name_or_path=path),
                      device="cpu")
    trainer.init_load_base_model()
    expected = load_transformer_params(model, init_adapters(model.create_module()), path).state_dict()
    got = trainer.module.state_dict()
    assert all(torch.equal(got[k], expected[k]) for k in expected if not k.endswith(("lora_A", "lora_B")))
    assert all(float(v.abs().max()) == 0 for k, v in got.items() if k.endswith("lora_B"))
    missing = str(tmp_path / "missing")
    strict = config_namespace({"model_family": "flux", "model_type": "lora", "lora_rank": 4,
                               "pretrained_model_name_or_path": missing})
    with pytest.raises(FileNotFoundError):
        Trainer(Flux(strict), strict, device="cpu").init_load_base_model()
    unset = config_namespace({"model_family": "flux", "model_type": "lora", "lora_rank": 4})
    with pytest.raises(ValueError, match="allow_untrained_init"):
        Trainer(Flux(unset), unset, device="cpu").init_load_base_model()
