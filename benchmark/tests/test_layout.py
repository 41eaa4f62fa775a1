"""The harness finds configurations, mixes, limits and metrics by the
names in ``BENCHMARK.json``; a new cell and metric are new files and
entries, with no edit to a file that is there; and nothing it loads is the
JAX package or JAX."""

import json
import shutil
import subprocess
import sys
import textwrap

from benchmark import harness

ROOT = harness.ROOT


def test_a_new_cell_and_metric_are_only_new_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    here = tmp_path / "benchmark"
    (here / "traffic" / "dummy-mix.json").write_text(json.dumps({"driver": "rollout", "rounds": 1}))
    (here / "limits" / "dummy-cell.json").write_text(json.dumps({"step": 0.1}))
    (here / "metrics" / "dummy_count.dummy.py").write_text("def read(rec):\n    return 7.0\n")
    spec["workloads"].append({"name": "dummy-cell", "config": spec["configs"][0]["name"],
                              "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("dummy-cell")
    spec["per_layer"].append({"name": "dummy_count.dummy", "unit": "n", "better": "lower",
                              "source": "program_counter", "layer": "Device (one H100)",
                              "moves": spec["end_to_end"][0]["name"],
                              "workloads": ["dummy-cell"]})
    _, cfg, traffic, limits = harness.cell_files(spec, "dummy-cell", here)
    assert traffic["rounds"] == 1 and limits == {"step": 0.1} and cfg["engine"]
    readers = harness.metric_readers(spec, "dummy-cell", here)
    assert set(readers) == {"dummy_count.dummy"}
    assert harness.per_layer(readers, {}) == {"dummy_count.dummy": {"value": 7.0, "unit": "n"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_every_cell_finds_its_files_and_metrics():
    spec = harness.load_spec()
    per_layer = {m["name"] for m in spec["per_layer"]}
    found = set()
    for w in spec["workloads"]:
        _, cfg, traffic, limits = harness.cell_files(spec, w["name"])
        assert cfg["name"] == w["config"] and limits
        readers = harness.metric_readers(spec, w["name"])
        assert readers
        found |= set(readers)
        reported = {m["name"] for m in harness.e2e_metrics(spec, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        for name in readers:
            m = next(m for m in spec["per_layer"] if m["name"] == name)
            assert m["moves"] in reported
    assert found == per_layer


def test_nothing_loaded_is_jax_or_the_jax_package():
    code = textwrap.dedent("""
        import json, sys
        from benchmark import harness, run, control, rollout, train, counts, trace, weights
        import benchmark.reference
        assert not [m for m in sys.modules if m.split(".")[0] == "vista_tpu_torch"], "reference"
        spec = harness.load_spec()
        for w in spec["workloads"]:
            harness.cell_files(spec, w["name"])
            harness.metric_readers(spec, w["name"])
        import vista_tpu_torch.engine.engine, vista_tpu_torch.engine.rollout
        import vista_tpu_torch.engine.training
        print(json.dumps(harness.forbidden_modules()))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["vista_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["vista_tpu.ops", "jax.numpy", "torch"]) == ["jax", "vista_tpu"]
