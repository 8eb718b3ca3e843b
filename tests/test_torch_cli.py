"""The port's ``simpletuner-tpu-torch`` CLI against the JAX ``simpletuner-tpu`` CLI, on the CPU.

``validate-config``, ``examples``, ``docs`` and ``models`` run in this process
on the same inputs through both ``main``s: the exit codes, the printed text
and the written files are equal.  ``optimizers`` lists the port's registry and
``version`` the port's version (``--full``: torch, CUDA and the card).
``train`` and ``inference`` run in subprocesses with ``--device cpu``: the
CLI trains tiny Flux and renders its last checkpoint, and the render is
bitwise the trainer's final validation image (``PYTHONHASHSEED`` is fixed
for both processes, as the tiny tokenizer hashes words per process).
Without ``--device``, on a machine without a card, both fail: nothing falls
back to the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from simpletuner_tpu.cli import main as jax_cli
from simpletuner_tpu.cli.examples import EXAMPLES as JAX_EXAMPLES

from simpletuner_tpu_torch import __version__
from simpletuner_tpu_torch.cli import build_parser
from simpletuner_tpu_torch.cli import main as port_cli
from simpletuner_tpu_torch.cli.examples import EXAMPLES
from simpletuner_tpu_torch.training.optimizers import optimizer_names

from test_torch_trainer import _metrics, _values, _write_images

REPO = Path(__file__).resolve().parents[1]


def _both(capsys, argv):
    """(exit code, stdout, stderr) of the JAX CLI and of the port's."""
    answers = []
    for cli in (jax_cli, port_cli):
        try:
            code = cli(list(argv))
        except SystemExit as exc:
            code = exc.code
        captured = capsys.readouterr()
        answers.append((code, captured.out, captured.err))
    return answers


@pytest.mark.parametrize("case", ["valid", "optimizer", "dataloader", "missing"])
def test_validate_config_matches_jax(tmp_path, capsys, case):
    values = {"model_family": "flux", "optimizer": "adamw", "learning_rate": 1e-4, "max_train_steps": 10,
              "data_backend_config": [
                  {"id": "train", "type": "local", "dataset_type": "image", "instance_data_dir": str(tmp_path)},
                  {"id": "embeds", "type": "local", "dataset_type": "text_embeds", "default": True}]}
    if case == "optimizer":
        values["optimizer"] = "nope"
    elif case == "dataloader":
        values["data_backend_config"] = [{"id": "train", "type": "local", "dataset_type": "image"}]
    path = tmp_path / "config.json"
    if case != "missing":
        path.write_text(json.dumps(values))
    theirs, ours = _both(capsys, ["validate-config", "--config", str(path)])
    assert ours == theirs
    assert (ours[0] == 0) == (case == "valid")


def test_examples_and_docs_match_jax(tmp_path, capsys):
    theirs, ours = _both(capsys, ["examples"])
    assert ours == theirs and ours[0] == 0 and len(ours[1].splitlines()) == len(EXAMPLES) == len(JAX_EXAMPLES)
    for name in EXAMPLES:
        written = {}
        for side, cli in (("jax", jax_cli), ("port", port_cli)):
            assert cli(["examples", name, "--output-dir", str(tmp_path / side / name)]) == 0
            out = capsys.readouterr().out
            path = Path(out.split("wrote ", 1)[1].strip())
            written[side] = (path.name, path.read_bytes())
        assert written["port"] == written["jax"], name
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        assert cli(["docs", "--output", str(tmp_path / f"{side}.md")]) == 0
    capsys.readouterr()
    assert (tmp_path / "port.md").read_bytes() == (tmp_path / "jax.md").read_bytes()


def test_models_optimizers_and_version(capsys):
    theirs, ours = _both(capsys, ["models"])
    assert ours == theirs and ours[0] == 0 and ours[1].startswith("flux ")
    assert port_cli(["optimizers"]) == 0
    assert capsys.readouterr().out.split() == list(optimizer_names())
    assert port_cli(["version"]) == 0
    assert capsys.readouterr().out.strip() == __version__
    assert port_cli(["version", "--full"]) == 0
    lines = dict(line.split(None, 1) for line in capsys.readouterr().out.strip().splitlines())
    assert lines["torch"] == torch.__version__ and lines["simpletuner_tpu_torch"] == __version__


def test_device_flags_default_to_the_card():
    parser = build_parser()
    assert parser.parse_args(["inference", "--checkpoint", "c", "--prompt", "p"]).device == "cuda"
    assert parser.parse_args(["server"]).device == "cuda"
    assert parser.parse_args(["server", "--device", "cpu"]).device == "cpu"


def _run(args, tmp_path, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(REPO), "PYTHONHASHSEED": "0"}
    return subprocess.run([sys.executable, "-m", "simpletuner_tpu_torch.cli", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_train_then_render_the_checkpoint(tmp_path):
    _write_images(tmp_path / "data")
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps(_values(tmp_path, "out", max_train_steps=2, validation_prompt="a photo",
                                         validation_resolution=64, validation_num_inference_steps=2,
                                         disable_benchmark=True)))
    result = _run(["train", "--config", str(config), "--device", "cpu"], tmp_path)
    assert result.returncode == 0, result.stderr[-3000:]
    assert [m["step"] for m in _metrics(tmp_path / "out")] == [1, 2]
    result = _run(["inference", "--checkpoint", str(tmp_path / "out" / "checkpoint-2"), "--config", str(config),
                   "--prompt", "a photo", "--output", str(tmp_path / "render"), "--steps", "2", "--resolution", "64",
                   "--seed", "42", "--device", "cpu"], tmp_path)
    assert result.returncode == 0, result.stderr[-3000:]
    path = result.stdout.strip().splitlines()[-1]
    assert path == str(tmp_path / "render" / "validation" / "step_2_0.png")
    final = np.asarray(Image.open(tmp_path / "out" / "validation" / "step_2_0.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), final)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default device would train on it")
@pytest.mark.parametrize("command", ["train", "inference"])
def test_no_fallback_to_the_cpu(tmp_path, command):
    _write_images(tmp_path / "data")
    config = tmp_path / "cfg.json"
    config.write_text(json.dumps(_values(tmp_path, "out", max_train_steps=1)))
    args = {"train": ["train", "--config", str(config)],
            "inference": ["inference", "--checkpoint", str(tmp_path), "--config", str(config), "--prompt", "p"]}
    result = _run(args[command], tmp_path, timeout=300)
    assert result.returncode != 0 and "torch.cuda.is_available() is False" in result.stderr
    assert not (tmp_path / "out" / "simpletuner-tpu-metrics.jsonl").exists()
