"""The port's eval loss against the JAX package's, on the CPU.

Both packages build their data plane from one config with three image
datasets: ``a`` trains, ``b`` is carved out by ``eval_dataset_id`` and ``e``
has ``dataset_type: eval``; both encode with the stand-in encoders of the
data-plane test.  The JAX ``EvalLoss`` and the port's evaluate tiny LoRA
Flux on the same numpy weights, with the same numpy noise and sigmas per
eval batch through the ``override_noise`` / ``override_sigmas`` batch hooks,
and agree within ``EVAL_TOL`` relative.  The port's ``num_eval_images``
(``max_batches``) and ``eval_timesteps`` (draws per batch, each from its own
generator seed) are held to the JAX semantics by counting what the loss
sees.  The trainer's ``eval_loss`` lines against the JAX ``Trainer``'s are in
``tests/test_torch_trainer.py``, on that file's fixture.
"""

import jax
import numpy as np
import pytest
import torch

from simpletuner_tpu import native as jax_native
from simpletuner_tpu.configuration import TrainingConfig as JaxTrainingConfig
from simpletuner_tpu.data import dataset as jax_dataset
from simpletuner_tpu.data import factory as jax_factory
from simpletuner_tpu.models import layers as jl
from simpletuner_tpu.models.flux.model import Flux as JaxFlux
from simpletuner_tpu.training.evaluation import EvalLoss as JaxEvalLoss

from simpletuner_tpu_torch.configuration import TrainingConfig
from simpletuner_tpu_torch.data import factory
from simpletuner_tpu_torch.models.flux import Flux
from simpletuner_tpu_torch.training import evaluation
from simpletuner_tpu_torch.training.evaluation import EvalLoss, eval_seed

from test_torch_data_plane import _write_dataset, stand_in_encode_text, stand_in_latents
from torch_parity import bridge, fill_numpy

# f32 on both sides over the same weights and noise: only the sum order differs
EVAL_TOL = 1e-5


def _values(tmp_path, side, **extra):
    dataset = dict(type="local", resolution=64, resolution_type="pixel_area", aspect_bucket_alignment=16,
                   caption_strategy="textfile", repeats=0)
    return {
        "model_family": "flux", "model_type": "lora", "lora_rank": 4, "model_arch_preset": "tiny",
        "mixed_precision": "fp32", "seed": 5, "train_batch_size": 1, "cache_dir": str(tmp_path / side / "cache"),
        "eval_dataset_id": "b",
        "data_backend_config": [
            {**dataset, "id": "a", "dataset_type": "image", "instance_data_dir": str(tmp_path / "a"),
             "cache_dir_vae": str(tmp_path / side / "vae_a")},
            {**dataset, "id": "b", "dataset_type": "image", "instance_data_dir": str(tmp_path / "b"),
             "cache_dir_vae": str(tmp_path / side / "vae_b")},
            {**dataset, "id": "e", "dataset_type": "eval", "instance_data_dir": str(tmp_path / "e"),
             "cache_dir_vae": str(tmp_path / side / "vae_e")},
            {"id": "text", "type": "local", "dataset_type": "text_embeds", "default": True,
             "cache_dir": str(tmp_path / side / "text")},
        ],
        **extra,
    }


def _drop_metadata(tmp_path):
    for sub in ("a", "b", "e"):
        for path in (tmp_path / sub).iterdir():
            if path.name.startswith("aspect_ratio_bucket"):
                path.unlink()


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    """Both data planes, and tiny LoRA Flux with one set of numpy weights in both frameworks."""
    tmp_path = tmp_path_factory.mktemp("eval")
    _write_dataset(tmp_path / "a", 3, seed=1)
    _write_dataset(tmp_path / "b", 3, seed=2)
    _write_dataset(tmp_path / "e", 4, seed=3)
    previous = jl._LORA_TARGET
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        jax_config = JaxTrainingConfig(_values(tmp_path, "jax"))
        jax_model = JaxFlux(jax_config)
        mp.setattr(jax_model, "encode_text", stand_in_encode_text, raising=False)
        mp.setattr(jax_model, "text_encoders", [], raising=False)
        theirs = jax_factory.configure_multi_databackend(jax_config, jax_model, vae_encode_fn=stand_in_latents)
    _drop_metadata(tmp_path)
    config = TrainingConfig(_values(tmp_path, "port"))
    model = Flux(config)
    model.encode_text = stand_in_encode_text
    ours = factory.configure_multi_databackend(config, model, vae_encode_fn=stand_in_latents)
    shapes = jax.eval_shape(lambda: jax_model.init_params(jax.random.PRNGKey(0)))
    variables = fill_numpy(shapes, seed=11)
    module = bridge(variables, model.create_module())
    yield dict(tmp_path=tmp_path, ours=ours, theirs=theirs, model=model, module=module, jax_model=jax_model,
               variables=variables)
    jl.set_lora_target(previous)


def _overriding(collate, calls):
    """``collate_batch`` with numpy noise and sigmas drawn per call, in order."""

    def collate_batch(samples, bundle, model, *args, **kwargs):
        batch = collate(samples, bundle, model, *args, **kwargs)
        rng = np.random.default_rng(3000 + len(calls))
        calls.append((bundle.id, [s["image_path"] for s in samples]))
        batch["override_noise"] = rng.standard_normal(batch["latents"].shape).astype(np.float32)
        batch["override_sigmas"] = rng.uniform(0.05, 0.95, batch["latents"].shape[0]).astype(np.float32)
        return batch

    return collate_batch


def _fresh(plane):
    """The plane's bundles with their samplers at the start of epoch 0."""
    for bundle in plane.bundles.values():
        bundle.sampler.load_state({"current_epoch": 0, "bucket_cursors": {}, "seen": [], "draws": 0})
    return list(plane.bundles.values())


def test_eval_split_is_carved_out_of_the_train_iterator(planes):
    for plane in (planes["ours"], planes["theirs"]):
        assert [b.id for b in plane.iterator.bundles] == ["a"]
        assert sorted(plane.bundles) == ["a", "b", "e"]
    ours = EvalLoss(planes["model"], list(planes["ours"].bundles.values()), eval_dataset_ids="b", device="cpu")
    theirs = JaxEvalLoss(planes["jax_model"], list(planes["theirs"].bundles.values()), eval_dataset_ids="b")
    assert [b.id for b in ours.bundles] == [b.id for b in theirs.bundles] == ["b", "e"]
    # without eval_dataset_id only the eval split
    assert [b.id for b in EvalLoss(planes["model"], list(planes["ours"].bundles.values()), device="cpu").bundles] \
        == ["e"]


@pytest.mark.parametrize("max_batches, draws", [(8, 1), (2, 3)])
def test_eval_loss_matches_jax(planes, monkeypatch, max_batches, draws):
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_dataset, "collate_batch", _overriding(jax_dataset.collate_batch, calls["jax"]))
    monkeypatch.setattr(evaluation, "collate_batch", _overriding(evaluation.collate_batch, calls["port"]))
    planes["jax_model"].apply_trace_globals()
    theirs = JaxEvalLoss(planes["jax_model"], _fresh(planes["theirs"]), seed=5, max_batches=max_batches,
                         eval_dataset_ids="b", draws_per_batch=draws)
    expected = theirs.execute_eval(jax.tree_util.tree_map(jax.numpy.asarray, planes["variables"]))
    ours = EvalLoss(planes["model"], _fresh(planes["ours"]), seed=5, max_batches=max_batches,
                    eval_dataset_ids="b", draws_per_batch=draws, device="cpu")
    got = ours.execute_eval(planes["module"])
    assert calls["port"] == calls["jax"]
    # num_eval_images caps the batches of each eval dataset (b: 3 images, e: 4)
    assert [bid for bid, _ in calls["port"]] == ["b"] * min(3, max_batches) + ["e"] * min(4, max_batches)
    assert np.isfinite(got) and abs(got - expected) <= EVAL_TOL * abs(expected), (got, expected)


def test_eval_timesteps_draw_from_their_own_seeds(planes, monkeypatch):
    """``eval_timesteps`` draws per batch, draw ``d`` of batch ``c`` from the
    evaluator's own generator seeded with ``eval_seed(seed, c * 1009 + d)``;
    the mean is over every draw, and a second run gives the same value."""
    seen = []
    loss_fn = planes["model"].loss_fn

    def recording(module, generator, batch):
        loss, aux = loss_fn(module, generator, batch)
        seen.append((generator.initial_seed(), float(loss)))
        return loss, aux

    monkeypatch.setattr(planes["model"], "loss_fn", recording)
    ours = EvalLoss(planes["model"], _fresh(planes["ours"]), seed=5, max_batches=2, draws_per_batch=3,
                    device="cpu")
    train_generator = torch.Generator().manual_seed(99)
    value = ours.execute_eval(planes["module"])
    assert [s for s, _ in seen] == [eval_seed(5, c * 1009 + d) for c in range(2) for d in range(3)]
    assert value == pytest.approx(np.mean([loss for _, loss in seen]), rel=1e-12)
    assert len({loss for _, loss in seen[:3]}) == 3  # the draws differ
    assert ours.generator is not train_generator and train_generator.initial_seed() == 99
    again = EvalLoss(planes["model"], _fresh(planes["ours"]), seed=5, max_batches=2, draws_per_batch=3,
                     device="cpu").execute_eval(planes["module"])
    assert again == value


def test_unknown_eval_dataset_id_is_refused_as_in_jax(planes):
    tmp_path = planes["tmp_path"]
    values = _values(tmp_path, "port", eval_dataset_id=["b", "nope"])
    model = Flux(TrainingConfig(values))
    model.encode_text = stand_in_encode_text
    with pytest.raises(ValueError, match=r"unknown dataset\(s\): \['nope'\]"):
        factory.configure_multi_databackend(TrainingConfig(values), model, vae_encode_fn=stand_in_latents)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "available", lambda: False)
        jax_config = JaxTrainingConfig(_values(tmp_path, "jax", eval_dataset_id=["b", "nope"]))
        jax_model = JaxFlux(jax_config)
        mp.setattr(jax_model, "encode_text", stand_in_encode_text, raising=False)
        mp.setattr(jax_model, "text_encoders", [], raising=False)
        with pytest.raises(ValueError, match=r"unknown dataset\(s\): \['nope'\]"):
            jax_factory.configure_multi_databackend(jax_config, jax_model, vae_encode_fn=stand_in_latents)
