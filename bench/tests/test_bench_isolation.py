"""What a run loads and where it refuses to run: no module whose top-level
name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX package; the
port's ``repro_torch`` is another name) in a run; nothing of the program
in the reference; no result line without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench.spec import Spec

ROOT = Spec().root


def _python(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax_and_no_jax_package():
    code = ("import json, sys\n"
            "from bench.tests import tiny\n"
            "from bench import harness\n"
            "c, out, line = tiny.run('qwen3-moe.prefill', trace=True)\n"
            "print(json.dumps({'correct': line['correct'], 'top': sorted("
            "{m.split('.')[0] for m in sys.modules}), 'bad': "
            "harness.forbidden_modules()}))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["bad"] == []
    assert "repro_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["top"])


def test_the_references_load_nothing_of_the_program():
    code = ("import sys\n"
            "import bench.reference.qwen3_moe, bench.reference.mamba2\n"
            "import bench.counts.moe, bench.counts.peaks\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not {"repro_torch", "repro", "jax"} & top


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


ARGS = ("--workload", "qwen3-moe.prefill", "--seed", str(2 ** 31 + 7),
        "--seconds", "1", "--trace", "0")


def test_no_result_without_a_card():
    proc = _run(ROOT, *ARGS)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_no_result_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, *ARGS)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("bad", ["--seed", "--workload"])
def test_arguments_are_required(bad):
    args = list(ARGS)
    i = args.index(bad)
    del args[i:i + 2]
    proc = _run(ROOT, *args)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
