"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), and its report against
``benchmarks/roofline_report.py``.

Both dry runs run in child interpreters, so no test process holds a
process group: the port's on fake worlds (a ``"fake"`` process group of
1, 4 or 256 ranks), the reference's on 4 XLA:CPU devices through
``tests/torch_dist_pair.py``'s prelude, at the same time.  The cells:

- (a) reduced qwen3-14b on a (2, 2) mesh, train (B=16, S=32, full remat),
  prefill (B=16, S=32) and decode (B=16, a 64-slot cache): the port's
  per-device FLOPs, collective payloads by kind and bytes against the
  reference's ``_lower_cell`` + ``_costs`` + ``analyze``;
- (b) the train cell at depths 1, 2 and 5: the counts lie on the
  reference's ``_lin`` line exactly (eager counts every layer);
- (c) FLOPs at (1, 4) and (4, 1) a quarter of (1, 1)'s, exactly (a
  global count would not be);
- (d) qwen3-14b × train_4k on 256 fake ranks through the CLI: the
  reference's result schema, in the H100's rates;
- (e) mamba2-370m × train_4k on 256 fake ranks: a roofline row whose
  FLOPs are at least the analytic floor;
- (f) the CLI's artifact read by both reports: the same rows;
- (g) reduced mamba2 on (2, 2), train, prefill and decode: FLOPs, bytes
  and collective payloads by kind against the reference's;
- and a thin decode batch (one sequence) on (2, 2), replicated;
- (h) context-parallel prefill (``act_sharding``, the activations'
  sequence on 'model') on (2, 2) for reduced qwen3-14b and
  qwen3-moe-235b-a22b against the reference's ``_lower_cell`` with
  ``act_sharding = NamedSharding(mesh, P("data", "model", None))``:
  FLOPs, bytes and collective payloads by kind; and on 256 fake ranks,
  ``--seq-shard-prefill``'s rows of qwen3-14b and mixtral-8x22b ×
  prefill_32k (F4: mixtral's differs from its flagless row).
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from repro.configs.registry import ALL_ARCHS as REF_ARCHS
from repro.configs.registry import reduced_config as ref_reduced
from repro.launch import roofline as ref_rl
from torch_dist_pair import ROOT, jax_running

REF_DRYRUN = ROOT / "src" / "repro" / "launch" / "dryrun.py"
ARCH = "qwen3-14b"
SSM_ARCH = "mamba2-370m"
# kind → (seq, batch) of the (2, 2) cells
CELLS = {"train": (32, 16), "prefill": (32, 16), "decode": (64, 16)}
DEPTHS = (1, 2, 5)

# (a)'s bounds, each with its reason (readings in PERF.md, section 6):
# FLOPs against the analytic floor a device.  Below it: the embedding is
# a gather (the analytic 2·N·D counts its table as a product), the
# prefill unembeds only the last position, the unembedding is not
# recomputed under remat.  Above it: the plain attention's full square
# (the analytic counts the causal half).
FLOOR_RATIO = (0.70, 1.10)
# FLOPs against XLA:CPU's count: XLA counts library dots as 0 FLOPs but
# counts elementwise ops, which FlopCounterMode does not.
XLA_FLOPS_RATIO = (0.95, 3.0)
# bytes against XLA's "bytes accessed": eager's unfused traffic (each
# elementwise op reads and writes its tensors; XLA fuses chains into one
# pass) and the plain attention's float32 scores.
BYTES_RATIO = (1.0, 4.0)
# collective payloads by kind: the same kinds, within a factor of 2.  XLA
# all-reduces the residual stream in float32 where the port does so in
# bfloat16 (twice the bytes a call), and merges some of them (the
# prefill: 3 all-reduces of f32[8,32,64] against the port's 5 of bf16);
# the port all-reduces each layer's gradients as DTensor redistributes
# them, XLA in its own groups.
COLL_RATIO = (0.5, 2.0)

# (g)'s bounds for reduced mamba2 on (2, 2), each with its reason
# (readings in PERF.md, section 6).  FLOPs against XLA's: both count the
# same products; XLA adds the elementwise ops, and under full remat the
# port recomputes the forward's products in the backward (train 1.086,
# prefill 0.9996, decode 0.987).
SSM_XLA_FLOPS_RATIO = (0.95, 1.15)
# all collective bytes against XLA's: XLA reshards the blocks of the
# packed projection and of the conv's channels with collective-permutes
# and all-to-alls of only the columns a rank needs, where the port
# gathers both whole (read 1.34 to 1.39; the cheaper exchange is parked
# in ROADMAP.md section 2).  The port's all-reduces are the norm's row
# sums, out_proj's reduce and the layers' data-parallel gradients.
SSM_COLL_TOTAL_RATIO = (1.0, 2.0)

# (h)'s cells: the context-parallel prefill of a dense and a moe model
CP_ARCHS = ("qwen3-14b", "qwen3-moe-235b-a22b")
# (h)'s bounds beyond (a)'s, each with its reason (readings in PERF.md,
# section 6).  The last position: XLA moves it from the last 'model' rank
# by a collective-permute and two masked all-reduces in float32 (f32[8,1]
# and f32[8,1,64]: 2,048 + 4,160 bytes); the port by one masked
# all-reduce of the bfloat16 row (2,048 bytes), against both of XLA's
# kinds together (read 0.33).
CP_LAST_ROW_RATIO = (0.25, 1.0)
# moe: XLA all-reduces the dispatch buffers (f32[4,320,64] twice,
# f32[512,64], f32[256,64]) besides the combine, with or without the
# constraint; the port all-reduces the combine alone (read 0.078; 0.167
# of XLA's without the constraint).  At most XLA's.
CP_MOE_ALL_REDUCE_RATIO = (0.0, 1.0)
# full-width cells of the dry run's --seq-shard-prefill on 256 fake ranks
# (arch, flag), each traced in a child of its own
WIDE_CELLS = (("qwen3-14b", True), ("mixtral-8x22b", True),
              ("mixtral-8x22b", False))

_PORT = r"""
import contextlib, dataclasses, io, json, sys
from repro_torch.configs.registry import get_arch, reduced_config
from repro_torch.launch import dryrun

out_dir = sys.argv[1]
cells, depths = json.loads(sys.argv[2]), json.loads(sys.argv[3])
cfg = reduced_config(get_arch(sys.argv[4]))

def trace(shape, cfg, kind):
    seq, batch = cells[kind]
    r = dryrun.host_cell(cfg, seq, batch, kind, tuple(shape))
    c = r["counted"]
    return dict(flops=c["flops"], bytes=c["bytes"], coll=c["collectives"],
                roofline=r["roofline"])

res = {"a": {k: trace((2, 2), cfg, k) for k in cells},
       "b": {L: trace((2, 2), dataclasses.replace(cfg, n_layers=L), "train")
             for L in depths},
       "c": {k: {f"{d}x{m}": trace((d, m), cfg, k)["flops"]
                 for d, m in ((1, 1), (1, 4), (4, 1))} for k in cells}}
# long_500k's thin batch: one sequence, its cache sequence-sharded
try:
    res["thin"] = dryrun.host_cell(
        reduced_config(get_arch("mixtral-8x22b")), 64, 1, "decode", (2, 2))
except Exception as e:  # noqa: BLE001 - the test reads it
    res["thin"] = {"error": f"{type(e).__name__}: {e}"}

def cli(name, *args):
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            dryrun.main([*args, "--out", f"{out_dir}/{name}.json"])
        code = 0
    except SystemExit as e:
        code = e.code
    res[name] = {"code": code, "stdout": out.getvalue()}

# (g): reduced mamba2 on (2, 2)
ssm = reduced_config(get_arch("mamba2-370m"))
res["g"] = {k: trace((2, 2), ssm, k) for k in cells}

# (h): context-parallel prefill on (2, 2)
seq, batch = cells["prefill"]
res["h"] = {}
for arch in json.loads(sys.argv[5]):
    r = dryrun.host_cell(reduced_config(get_arch(arch)), seq, batch,
                         "prefill", (2, 2), seq_shard_prefill=True)
    c = r["counted"]
    res["h"][arch] = dict(flops=c["flops"], bytes=c["bytes"],
                          coll=c["collectives"])

cli("d", "--arch", "qwen3-14b", "--shape", "train_4k")
cli("e", "--arch", "mamba2-370m", "--shape", "train_4k")
cli("skip", "--arch", "qwen3-14b", "--shape", "long_500k")
with open(f"{out_dir}/port.json", "w") as f:
    json.dump(res, f)
"""

_WIDE = r"""
import json, sys
from repro_torch.launch import dryrun
r = dryrun.dryrun_cell(sys.argv[2], "prefill_32k",
                       seq_shard_prefill=sys.argv[3] == "1", verbose=False)
with open(sys.argv[1], "w") as f:
    json.dump(r, f)
"""

_REF_CP = r"""
import json, sys
import jax
import numpy as np
jax.devices()          # 4 devices, before repro.launch.dryrun sets 512
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.registry import get_arch, reduced_config
from repro.launch.dryrun import _costs, _lower_cell
from repro.models.registry import build_model

out, (seq, batch) = sys.argv[1], json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
res = {}
for arch in json.loads(sys.argv[3]):
    cfg = reduced_config(get_arch(arch))
    model = build_model(cfg, remat_policy="full", attn_impl="ref")
    model.act_sharding = NamedSharding(mesh, P("data", "model", None))
    compiled = _lower_cell(cfg, model, seq, batch, "prefill", False,
                           mesh).compile()
    f, b, coll = _costs(compiled)
    res[arch] = dict(flops=f, bytes=b, coll=coll)
with open(out, "w") as fh:
    json.dump(res, fh)
"""

_REF = r"""
import json, sys
import jax
import numpy as np
jax.devices()          # 4 devices, before repro.launch.dryrun sets 512
from jax.sharding import Mesh
from repro.configs.registry import get_arch, reduced_config
from repro.launch import roofline as rl
from repro.launch.dryrun import _costs, _lower_cell
from repro.models.registry import build_model

out, cells = sys.argv[1], json.loads(sys.argv[2])
cfg = reduced_config(get_arch(sys.argv[3]))
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
res = {}
for kind, (seq, batch) in cells.items():
    model = build_model(cfg, remat_policy="full", attn_impl="ref")
    compiled = _lower_cell(cfg, model, seq, batch, kind, False,
                           mesh).compile()
    f, b, coll = _costs(compiled)
    roof = rl.analyze(compiled, cfg, seq, batch, kind, 4)
    res[kind] = dict(flops=f, bytes=b, coll=coll, roofline=roof.to_dict())
with open(out, "w") as fh:
    json.dump(res, fh)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' dry runs: the port's counts and CLI artifacts, the
    reference's (2, 2) cells."""
    d = tmp_path_factory.mktemp("dryrun")
    cells = json.dumps(CELLS)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    wide = [subprocess.Popen(
        [sys.executable, "-c", _WIDE, str(d / f"wide_{a}_{int(f)}.json"), a,
         str(int(f))], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=ROOT, env=env) for a, f in WIDE_CELLS]
    try:
        with jax_running(_REF, 4, str(d / "ref.json"), cells, ARCH), \
                jax_running(_REF, 4, str(d / "ssm.json"), cells,
                            SSM_ARCH), \
                jax_running(_REF_CP, 4, str(d / "ref_cp.json"),
                            json.dumps(CELLS["prefill"]),
                            json.dumps(CP_ARCHS)):
            out = subprocess.run(
                [sys.executable, "-c", _PORT, str(d), cells,
                 json.dumps(DEPTHS), ARCH, json.dumps(CP_ARCHS)],
                capture_output=True, text=True, timeout=600, cwd=ROOT,
                env=env)
            assert out.returncode == 0, \
                out.stdout[-3000:] + out.stderr[-3000:]
        for proc in wide:
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stdout[-3000:] + stderr[-3000:]
    finally:
        for proc in wide:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    port = json.loads((d / "port.json").read_text())
    port["wide"] = {(a, f): json.loads(
        (d / f"wide_{a}_{int(f)}.json").read_text()) for a, f in WIDE_CELLS}
    ref = json.loads((d / "ref.json").read_text())
    ref["g"] = json.loads((d / "ssm.json").read_text())
    ref["h"] = json.loads((d / "ref_cp.json").read_text())
    return d, port, ref


def _within(got, want, bounds):
    lo, hi = bounds
    return lo * want <= got <= hi * want


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_flops_against_the_reference_and_its_floor(runs, kind):
    _, port, ref = runs
    seq, batch = CELLS[kind]
    floor = ref_rl.analytic_hlo_flops(ref_reduced(REF_ARCHS[ARCH]), seq,
                                      batch, kind, "full") / 4
    got = port["a"][kind]["flops"]
    assert _within(got, floor, FLOOR_RATIO), (got, floor)
    assert _within(got, ref[kind]["flops"], XLA_FLOPS_RATIO), \
        (got, ref[kind]["flops"])
    # both rooflines take the floor where the count is below it
    assert ref[kind]["roofline"]["flops_per_device"] == \
        max(ref[kind]["flops"], floor)
    assert port["a"][kind]["roofline"]["flops_per_device"] == \
        max(got, floor)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_bytes_against_the_reference(runs, kind):
    _, port, ref = runs
    got, want = port["a"][kind]["bytes"], ref[kind]["bytes"]
    assert _within(got, want, BYTES_RATIO), (got, want)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_collectives_by_kind_against_the_reference(runs, kind):
    _, port, ref = runs
    got, want = port["a"][kind]["coll"], ref[kind]["coll"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert _within(got[k], want[k], COLL_RATIO), (k, got[k], want[k])


def _ref_function(name: str):
    """A function of the reference's dry run, compiled from its source
    alone: importing the module would set its XLA_FLAGS and import JAX's
    512-device world into this process."""
    tree = ast.parse(REF_DRYRUN.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns: dict = {}
    exec(compile(ast.Module([fn], []), str(REF_DRYRUN), "exec"), ns)
    return ns[name]


def test_counts_lie_on_the_reference_depth_line(runs):
    _, port, _ = runs
    lin = _ref_function("_lin")
    c = {int(k): (v["flops"], v["bytes"], v["coll"])
         for k, v in port["b"].items()}
    k1, k2, L = DEPTHS
    f, by, coll = lin(c[k1], c[k2], k1, k2, L)
    assert (f, by, coll) == c[L]
    assert c[k2][0] > c[k1][0]          # the depth is counted at all


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_flops_are_the_shards_own(runs, kind):
    _, port, _ = runs
    f = port["c"][kind]
    assert f["1x4"] == f["1x1"] / 4
    assert f["4x1"] == f["1x1"] / 4


def test_a_thin_batch_decodes_replicated(runs):
    """A batch the data axes do not divide (long_500k's one sequence) is
    replicated, as ``input_shardings(batch_size=)`` says; placing it over
    'data' raised before the dry run found it."""
    _, port, _ = runs
    r = port["thin"]
    assert "error" not in r, r["error"]
    assert (r["batch"], r["mesh"]) == (1, "2x2")
    assert r["counted"]["flops"] > 0 and r["roofline"]["step_s"] > 0


def _ref_result_keys():
    """The keys of ``dryrun_cell``'s result dict and its "opts", read from
    the reference's source."""
    tree = ast.parse(REF_DRYRUN.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "result":
            keys = [k.value for k in node.value.keys]
            opts = next(v for k, v in zip(node.value.keys, node.value.values)
                        if k.value == "opts")
            return keys, [k.value for k in opts.keys]
    raise AssertionError("no result dict in the reference")


def test_full_width_cell_has_the_reference_schema(runs):
    d, port, _ = runs
    assert port["d"]["code"] == 0
    assert "dry-run: 1 compiled, 0 skipped (documented), 0 failed" in \
        port["d"]["stdout"]
    [cell] = json.loads((d / "d.json").read_text())
    keys, opts = _ref_result_keys()
    assert list(cell) == keys and list(cell["opts"]) == opts
    ref_roof = ref_rl.Roofline(1.0, 1.0, 1.0, {}, 1.0, 1).to_dict()
    r = cell["roofline"]
    assert list(r) == list(ref_roof)
    assert (cell["mesh"], cell["kind"], cell["seq"], cell["batch"]) == \
        ("16x16", "train", 4096, 256)
    assert r["n_devices"] == 256 and cell["compile_s"] == 0.0
    # the H100's rates, never the TPU's
    assert r["compute_s"] == r["flops_per_device"] / 989e12
    assert r["memory_s"] == r["bytes_per_device"] / 3.35e12
    assert r["collective_s"] == r["coll_bytes_per_device"] / 450e9
    cfg = REF_ARCHS[ARCH]
    floor = ref_rl.analytic_hlo_flops(cfg, 4096, 256, "train") / 256
    assert r["flops_per_device"] >= floor
    assert r["model_flops_global"] == ref_rl.model_flops(cfg, 4096, 256,
                                                         "train")
    assert {"all-reduce", "all-gather"} <= set(r["coll_breakdown"])
    # the state a rank holds (bf16 parameters, float32 moments) fits in
    # the peak, which is under the card's 80 GB
    assert 0 < cell["output_bytes"] < cell["bytes_per_device"] < 80e9


def test_ssm_cell_is_a_roofline_row(runs):
    """mamba2-370m × train_4k on 256 fake ranks: the packed projection and
    the conv's channels on 'model', a roofline row whose FLOPs a device
    are at least the analytic floor, its collectives the gathers and the
    all-reduces."""
    d, port, _ = runs
    assert port["e"]["code"] == 0
    assert "dry-run: 1 compiled, 0 skipped (documented), 0 failed" in \
        port["e"]["stdout"]
    [cell] = json.loads((d / "e.json").read_text())
    r = cell["roofline"]
    cfg = REF_ARCHS[SSM_ARCH]
    floor = ref_rl.analytic_hlo_flops(cfg, 4096, 256, "train") / 256
    assert r["flops_per_device"] >= floor > 0
    assert set(r["coll_breakdown"]) == {"all-reduce", "all-gather"}
    assert 0 < cell["output_bytes"] < cell["bytes_per_device"] < 80e9


def test_both_reports_give_the_same_rows(runs, monkeypatch):
    d, port, _ = runs
    cells = [json.loads((d / f"{n}.json").read_text())[0]
             for n in ("d", "e", "skip")]
    assert "skipped" in cells[2]
    art = d / "art.json"
    art.write_text(json.dumps(cells))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    monkeypatch.syspath_prepend(str(ROOT / "benchmarks"))
    ref, mine = load("roofline_report"), load("torch_roofline_report")
    monkeypatch.setattr(ref, "ART", str(art))
    monkeypatch.setattr(mine, "ART", str(art))
    rows = mine.rows(mine.run("cpu"))
    assert rows == ref.run()
    assert [r["name"] for r in rows] == [
        "roofline/qwen3-14b/train_4k", "roofline/mamba2-370m/train_4k",
        "roofline/qwen3-14b/long_500k"]
    assert rows[1]["derived"].startswith("dom=memory "), rows[1]
    # no artifact: the reference's row, naming the port's dry run
    monkeypatch.setattr(ref, "ART", str(d / "absent.json"))
    monkeypatch.setattr(mine, "ART", str(d / "absent.json"))
    [row], [ref_row] = mine.rows(mine.run("cpu")), ref.run()
    assert row == {**ref_row,
                   "derived": "run repro_torch.launch.dryrun --all first"}


# ------------------------------------------- (g) reduced mamba2 on (2, 2)

def _ssm_layer_gathers(kind: str) -> float:
    """The bytes the port's gathers deliver a rank in one cell: each
    layer's packed projection (2di + 2n + h columns) and conv output
    (di + 2n channels) whole, bfloat16, for the rank's B / 2 sequences;
    the train step's full remat runs each forward twice."""
    cfg = ref_reduced(REF_ARCHS[SSM_ARCH])
    seq, batch = CELLS[kind]
    di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    h = di // cfg.ssm_head_dim
    rows = batch // 2 * (seq if kind != "decode" else 1)
    passes = 2 if kind == "train" else 1
    return cfg.n_layers * passes * rows * (3 * di + 4 * n + h) * 2


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_ssm_flops_against_the_reference_and_its_floor(runs, kind):
    _, port, ref = runs
    seq, batch = CELLS[kind]
    floor = ref_rl.analytic_hlo_flops(ref_reduced(REF_ARCHS[SSM_ARCH]), seq,
                                      batch, kind, "full") / 4
    got = port["g"][kind]["flops"]
    assert _within(got, floor, FLOOR_RATIO), (got, floor)
    assert _within(got, ref["g"][kind]["flops"], SSM_XLA_FLOPS_RATIO), \
        (got, ref["g"][kind]["flops"])


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_ssm_bytes_against_the_reference(runs, kind):
    _, port, ref = runs
    got, want = port["g"][kind]["bytes"], ref["g"][kind]["bytes"]
    assert _within(got, want, BYTES_RATIO), (got, want)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_ssm_collectives_by_kind_against_the_reference(runs, kind):
    """The port's kinds are the reference's all-reduce and all-gather
    (XLA adds permutes and all-to-alls); the all-reduces within
    COLL_RATIO, all of it within SSM_COLL_TOTAL_RATIO."""
    _, port, ref = runs
    got, want = port["g"][kind]["coll"], ref["g"][kind]["coll"]
    assert set(got) == {"all-reduce", "all-gather"} <= set(want)
    assert _within(got["all-reduce"], want["all-reduce"], COLL_RATIO), \
        (got, want)
    assert _within(sum(got.values()), sum(want.values()),
                   SSM_COLL_TOTAL_RATIO), (got, want)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_ssm_gathers_are_the_activations_alone(runs, kind):
    """The port's all-gather bytes are exactly each layer's packed
    projection and conv output: no weight is gathered."""
    _, port, _ = runs
    assert port["g"][kind]["coll"]["all-gather"] == _ssm_layer_gathers(kind)


# ------------------------------------- (h) context-parallel prefill, (2, 2)

def _cp_gathers(arch: str) -> float:
    """The bytes the port's gathers deliver a rank in (h)'s prefill cell,
    bfloat16: the embedding table once; each layer's weights that 'model'
    shards (attention's four, and a dense MLP's), its rotated keys and
    values (the rank's B / 2 sequences, whole), and for moe the
    activations along the sequence before the block, and the ranks'
    tokens-per-expert counts (int32) of the dispatch over 'data'."""
    cfg = ref_reduced(REF_ARCHS[arch])
    seq, batch = CELLS["prefill"]
    d, hd, b = cfg.d_model, cfg.hd, batch // 2
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    kv = 2 * b * cfg.n_kv_heads * seq * hd
    if cfg.family == "moe":
        layer = (attn + kv + b * seq * d) * 2 + 2 * cfg.n_experts * 4
    else:
        layer = (attn + kv + 3 * d * cfg.d_ff) * 2
    return cfg.vocab_padded * d * 2 + cfg.n_layers * layer


@pytest.mark.parametrize("arch", CP_ARCHS)
def test_cp_flops_and_bytes_against_the_reference(runs, arch):
    """The FLOPs within (a)'s XLA_FLOPS_RATIO of XLA's and the bytes
    within BYTES_RATIO.  The traced rank holds the sequence's last block,
    whose queries attend every key: a dense cell's FLOPs are exactly the
    unconstrained cell's (half the rows through whole weights against all
    the rows through half the columns)."""
    _, port, ref = runs
    got, want = port["h"][arch], ref["h"][arch]
    assert _within(got["flops"], want["flops"], XLA_FLOPS_RATIO), \
        (got["flops"], want["flops"])
    assert _within(got["bytes"], want["bytes"], BYTES_RATIO), \
        (got["bytes"], want["bytes"])
    if arch == ARCH:
        assert got["flops"] == port["a"]["prefill"]["flops"]


@pytest.mark.parametrize("arch", CP_ARCHS)
def test_cp_collectives_against_the_reference(runs, arch):
    """The reference's plan: the weights, the rotated keys and values
    (and for moe the activations) all-gathered, exactly
    :func:`_cp_gathers`' bytes, within COLL_RATIO of XLA's all-gathers;
    no all-reduce of a dense layer's residual: a dense cell all-reduces
    the last position alone (one bfloat16 row a sequence), against XLA's
    move of it within CP_LAST_ROW_RATIO; moe adds the combine's
    all-reduce a layer, at most XLA's (CP_MOE_ALL_REDUCE_RATIO).  The
    port's kinds are XLA's all-gather and all-reduce; XLA adds a
    collective-permute (the last position, and for moe the experts'
    weights, which it permutes without the constraint too)."""
    _, port, ref = runs
    got, want = port["h"][arch]["coll"], ref["h"][arch]["coll"]
    assert set(got) == {"all-gather", "all-reduce"}, got
    assert set(want) == set(got) | {"collective-permute"}, want
    assert got["all-gather"] == _cp_gathers(arch)
    assert _within(got["all-gather"], want["all-gather"], COLL_RATIO), \
        (got, want)
    cfg = ref_reduced(REF_ARCHS[arch])
    seq, batch = CELLS["prefill"]
    last_row = batch // 2 * cfg.d_model * 2 * 2      # bf16, all-reduce ×2
    if cfg.family == "moe":
        combine = batch // 2 * seq * cfg.d_model * 2 * 2
        assert got["all-reduce"] == last_row + cfg.n_layers * combine
        assert _within(got["all-reduce"], want["all-reduce"],
                       CP_MOE_ALL_REDUCE_RATIO), (got, want)
    else:
        assert got["all-reduce"] == last_row
        assert _within(got["all-reduce"], want["all-reduce"]
                       + want["collective-permute"], CP_LAST_ROW_RATIO), \
            (got, want)


def test_a_dense_prefill_cell_with_the_flag_is_a_roofline_row(runs):
    """qwen3-14b × prefill_32k with --seq-shard-prefill on 256 fake ranks:
    a roofline row (the port raised NotImplementedError before it held
    context-parallel prefill), its collectives the weights' and keys'
    all-gathers with a last position's all-reduce, no longer each
    layer's all-reduce of the residual."""
    r = port_row = runs[1]["wide"][("qwen3-14b", True)]
    assert "roofline" in port_row, r
    roof = r["roofline"]
    assert roof["flops_per_device"] > 0 and roof["step_s"] > 0
    coll = roof["coll_breakdown"]
    assert set(coll) == {"all-gather", "all-reduce"}, coll
    cfg = REF_ARCHS["qwen3-14b"]
    # the last position, one bf16 row of d a sequence of the rank's 2
    assert coll["all-reduce"] == 2 * cfg.d_model * 2 * 2, coll
    assert 0 < r["output_bytes"] < r["bytes_per_device"] < 80e9


def test_f4_the_flag_shards_a_moe_prefill_cell(runs):
    """F4: mixtral-8x22b × prefill_32k with --seq-shard-prefill on 256
    fake ranks is the context-parallel row, not the flagless one: its
    collectives differ (the attention's weights and keys all-gathered,
    no all-reduce of the attention's residual), and the row keeps the
    reference's schema, whose opts do not record the flag."""
    wide = runs[1]["wide"]
    on, off = wide[("mixtral-8x22b", True)], wide[("mixtral-8x22b", False)]
    assert "roofline" in on and "roofline" in off, (on, off)
    c_on = on["roofline"]["coll_breakdown"]
    c_off = off["roofline"]["coll_breakdown"]
    assert c_on != c_off, c_on
    assert c_on["all-gather"] > c_off.get("all-gather", 0.0)
    assert c_on["all-reduce"] < c_off["all-reduce"]
    keys, opts = _ref_result_keys()
    assert list(on) == keys and list(on["opts"]) == opts
    assert on["opts"] == off["opts"]
