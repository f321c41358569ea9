"""BENCHMARK.json against the contract's shape, and the files it names."""

import json
import os
import re

from benchmark import harness, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.manifest()


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in names
        traffic.load_mix(w["traffic"])
        names += [w["name"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
               ) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for w in BENCH["workloads"]:
        own = harness.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in own} and len(own) >= 2
        layer = harness.cell_metrics(BENCH, w["name"], True)
        assert layer and all(m["moves"] in {x["name"] for x in own}
                             for m in layer)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        roof = m["name"].split(".")[0].endswith("_roofline") \
            or "mfu" in m["name"]
        assert m["unit"] == "%" or not roof


def test_import_guard_compares_whole_names():
    import sys
    import types

    saved = dict(sys.modules)
    try:
        for name in ("visionselector_tpu_torch", "visionselector_tpu_torch.x",
                     "jaxlike", "benchmark"):
            sys.modules.setdefault(name, types.ModuleType(name))
        assert harness.forbidden_modules() == []
        sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
        sys.modules["visionselector_tpu.core"] = types.ModuleType("v")
        assert harness.forbidden_modules() == ["jax", "visionselector_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_check_imports_raises_on_jax():
    import sys
    import types

    import pytest

    saved = dict(sys.modules)
    try:
        harness.check_imports("here")  # nothing forbidden loaded
        sys.modules["jaxlib.xla"] = types.ModuleType("jaxlib.xla")
        with pytest.raises(harness.ForbiddenImport, match="jaxlib"):
            harness.check_imports("here")
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
