"""The plain reference (``perfbench/reference``) against the port's CPU
path at tiny sizes: the frozen generator, the codes, each table's
(distance, id) top-l, the union and the answer of each cell's entry."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench import data  # noqa: E402
from perfbench.harness import run  # noqa: E402
from perfbench.reference import generator  # noqa: E402
from perfbench.reference.hyperplane import (HyperplaneReference,  # noqa: E402
                                            round_tf32)
from perfbench.tests.sizes import CELLS, SIZES  # noqa: E402
from repro_torch.core import functions as F  # noqa: E402
from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.serving import batch_query as bq  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402
from repro_torch.utils.bits import unpack_signs  # noqa: E402

ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", (0, 7, 2_000_000_017))
@pytest.mark.parametrize("d,k", ((33, 20), (601, 16)))
def test_generator_is_the_programs(seed, d, k):
    for t in range(4):
        s = generator.table_seed(seed, t)
        assert s == F.table_seed(seed, t)
        u, v = generator.factors(s, d, k, CPU)
        pu, pv = F.seeded_projections(s, d, k)
        assert torch.equal(u, pu) and torch.equal(v, pv)


def _data(seed=3, n_lab=600, n_unl=3000, d=32):
    x, y = data.tiny1m(seed, CPU, n_lab, n_unl, d, 10)
    return x, y


def _index(x, seed=5):
    cfg = IndexConfig(method="bh", bits=20, tables=4, seed=seed)
    return MultiTableIndex(cfg, device="cpu").fit(x)


def test_codes_match_the_programs():
    x, y = _data()
    index = _index(x)
    ref = HyperplaneReference(x, [f.seed for f in index.families], 20)
    want = ref.signs(x) > 0
    got = unpack_signs(bq.hash_database_all(index.families, x), 20) > 0
    diff = want != got
    # a bit may differ only where a projection sits at rounding distance
    # from zero
    proj = torch.stack([torch.minimum((x.double() @ f.u.double()).abs(),
                                      (x.double() @ f.v.double()).abs())
                        for f in index.families])
    assert not diff[proj > 1e-5].any()
    assert diff.float().mean() < 1e-3


def test_table_topl_and_union_match_the_programs():
    x, y = _data()
    index = _index(x)
    w = data.normals(x, y, 48, 1, 1.0)
    ref = HyperplaneReference(x, [f.seed for f in index.families], 20)
    _, got = index.scan_table_topk(w.numpy(), l=16)
    want = ref.table_topl(w, 16).numpy()
    assert (got == want).mean() > 0.99
    res = index.query_scan_batch(w.numpy(), l=16)
    unions = ref.unions(w, 16)
    same = [np.array_equal(np.sort(c), u)
            for c, u in zip(res.candidates, unions)]
    assert np.mean(same) > 0.95
    # the answer is the least float64 margin of the program's candidates
    for qi, c in enumerate(res.candidates):
        m, _ = ref.margins(w[qi:qi + 1], torch.from_numpy(np.sort(c))[None])
        assert np.sort(c)[int(m.argmin())] == res.ids[qi] or \
            float(m.min()) == pytest.approx(float(res.margins[qi]), rel=1e-5)


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.0000002, 1e-30])
    r = round_tf32(t)
    assert r[0] == 1.0 and r[1] == 1.0          # ties to even
    assert r[2] == 1.0 + 2 ** -9 and r[3] == -3.0
    m = (r.view(torch.int32) & 0x1FFF)
    assert (m == 0).all()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_entry_matches_the_reference(cell):
    out = run(ROOT, cell, 424_242, 0.6, False,
              require_cuda=False, device="cpu", size=SIZES[cell])
    c = out["checks"]
    assert out["correct"], c
    assert c["unanswered"]["value"] == 0 and out["attempted"] > 0
    assert c["cand_mismatch"]["value"] == 0.0
    assert c["margin_err"]["value"] < 1e-5
