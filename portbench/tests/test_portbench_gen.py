"""The generator: deterministic by seed, the published shapes kept."""
import json

import pytest
import torch

from portbench import gen, spec

from conftest import small_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_data(workload):
    cfg = small_cell(workload)["config"]
    a = gen.generate(cfg, 2**31 + 12345, "cpu")
    b = gen.generate(cfg, 2**31 + 12345, "cpu")
    c = gen.generate(cfg, 7, "cpu")
    for x, y in ((a.indices, b.indices), (a.values, b.values),
                 (a.labels, b.labels)):
        assert torch.equal(x, y)
    assert not torch.equal(a.indices, c.indices)


@pytest.mark.parametrize("workload", CELLS)
def test_rows_keep_the_published_widths(workload):
    cfg = small_cell(workload)["config"]
    p = gen.generate(cfg, 3, "cpu")
    live = p.values != 0
    width = live.sum(1)
    d = cfg["features"]
    assert p.n_features == d + 1
    # the intercept is the last live slot of every row
    last = p.indices.gather(1, (width - 1)[:, None])[:, 0]
    assert torch.all(last == d)
    assert torch.all(p.values[live] == cfg["value"])
    assert torch.all(p.indices[~live] == 0)
    fields = cfg["fields"]
    if all(isinstance(f["per_row"], int) for f in fields):
        assert torch.all(width == sum(f["per_row"] for f in fields) + 1)
        base = 0
        for j, f in enumerate(fields):  # one id a field, in its own block
            ids = p.indices[:, j]
            assert torch.all((ids >= base) & (ids < base + f["vocab"]))
            base += f["vocab"]
    else:
        (f,) = fields
        spec_w = f["per_row"]
        w = width - 1
        assert int(w.sum()) == round(spec_w["mean"] * cfg["rows"])
        assert int(w.min()) >= spec_w["min"]
        assert int(w.max()) <= spec_w["max"]


def test_every_seed_deals_the_same_widths():
    cfg = small_cell("kdda-lr.l2-grid8")["config"]
    a = (gen.generate(cfg, 1, "cpu").values != 0).sum(1)
    b = (gen.generate(cfg, 2, "cpu").values != 0).sum(1)
    assert not torch.equal(a, b)
    assert torch.equal(torch.sort(a).values, torch.sort(b).values)


def test_gamma_widths_match_their_mean():
    spec_w = {"mean": 36.349113, "gamma_shape": 16, "min": 1, "max": 256}
    w = gen.field_widths(spec_w, 100_000)
    assert int(w.sum()) == round(36.349113 * 100_000)
    assert torch.all(w[1:] >= w[:-1] - 1)  # stratified, ascending


@pytest.mark.parametrize("name", ["kdda-lr", "criteo-lr"])
def test_configs_differ_from_their_source_only_where_reduced(name):
    entry = {c["name"]: c for c in spec.load_benchmark()["configs"]}[name]
    with open(spec.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["reduced"] == entry["reduced"]
    pub = cfg["published"]
    for key in ("rows", "features"):
        assert (cfg[key] != pub[key]) == (key in cfg["reduced"])
    assert sum(f["vocab"] for f in cfg["fields"]) <= cfg["features"]
