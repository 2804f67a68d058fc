"""The port's row-sharded scan (``mesh=``) on the CPU, held to the JAX
package's and to the port's own single-device scan.

The JAX side runs in one subprocess per shard count with
``--xla_force_host_platform_device_count=S`` (as tests/test_distribution.py
does), both started together; the port runs the same inputs on a mesh of S
shards co-located on the CPU.  The JAX local stage takes its plain jnp
scan (``use_kernel=False``), which the JAX package holds bit-identical to
its Pallas kernels.

Tolerances, stated per check:
- integer stages (distances, ids, sentinels, tie order, candidate lists,
  table hits) identical bit for bit, port against JAX and port mesh
  against port single-device;
- port against JAX through an index: each package hashes the queries (and
  the LSM's inserted rows) itself, and a code bit may differ only where
  its projection lies within the float32 rounding bound of zero; answers
  are compared for the queries whose codes agree in every table (at least
  90%), the inserted rows must hash identically (asserted).  Margins agree
  within rtol 1e-5 plus the float32 rounding bound of the d-term dot
  product, and ids may differ only where two margins tie within it;
- port mesh against port single-device: margins identical too (same
  features, same re-rank).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core.search import drop_tombstones_topk as j_drop  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.indexer import IndexConfig  # noqa: E402
from repro_torch.data.synthetic import tiny1m_like  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import sign_flip_ratios  # noqa: E402
from repro_torch.serving import batch_query as tbq  # noqa: E402
from repro_torch.serving.async_service import \
    AsyncHashQueryService  # noqa: E402
from repro_torch.serving.cluster import ShardReplicaRouter  # noqa: E402
from repro_torch.serving.lsm import LSMMultiTableIndex  # noqa: E402
from repro_torch.serving.multi_table import MultiTableIndex  # noqa: E402
from repro_torch.serving.service import HashQueryService  # noqa: E402
from repro_torch.utils.bits import from_numpy_u32, to_numpy_u32  # noqa: E402
from repro_torch.utils.mesh import Mesh, make_mesh, shard_count  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
SELECTS = ("hist", "argmin")
PACKS = ("none", "16", "8")
COMBOS = [(s, p) for s in SELECTS for p in PACKS]
# the cases of tests/test_distribution.py: (g, n, b, w, l) and the
# (select, pack) combinations each runs under; every combination sees the
# ragged shards, l > n and the ties across every shard boundary
CASES = {
    "even": ((3, 512, 4, 2, 16), [("hist", "16"), ("argmin", "8")]),
    "ragged": ((2, 1001, 3, 2, 8), COMBOS),
    "ragged_l_gt_n": ((2, 37, 3, 2, 40), COMBOS),
    "tiny": ((1, 5, 2, 1, 12), [("hist", "none"), ("argmin", "16")]),
    "ties": ((2, 103, 3, 2, 60), COMBOS),
    # 140,001 rows: 70,001 per shard at S = 2 and 35,001 at S = 4, past
    # the int16 id range, so the ids cross the gather unpacked
    "wide_shards": ((1, 140_001, 2, 1, 24), [("hist", "16"),
                                              ("argmin", "none")]),
    # 20,001 rows: at most 10,001 per shard, packed ids
    "narrow_shards": ((1, 20_001, 2, 1, 24), [("hist", "16")]),
    # zero queries: the zero padding rows are the nearest rows of the last
    # shard, whose real tail rows (one bit set) are the global top-l, so
    # a local depth of l alone would lose some of them
    "pad_tail": ((2, 1001, 3, 2, 16), [("hist", "16"), ("argmin", "none")]),
}
SINGLE_N = 1024          # hamming_topk_sharded: divides both shard counts
INDEX_ROWS, INDEX_L, INDEX_TOPK = 597, 16, 4
INDEX_CFG = dict(method="bh", bits=18, tables=3)
LSM_CFG = dict(method="bh", bits=14, tables=2, seed=3, lsm_auto=False)
LSM_N0, LSM_L, LSM_TOPK = 300, 9, 3

_JAX_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core.indexer import IndexConfig
from repro.core.search import (hamming_topk_grouped_sharded,
                               hamming_topk_sharded)
from repro.serving import (HashQueryService, LSMMultiTableIndex,
                           MultiTableIndex)
from repro.serving import batch_query as bq

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
S = spec["shards"]
mesh = jax.make_mesh((S,), ("data",))
out = {}
for name, l, combos in spec["cases"]:
    codes = jnp.asarray(inp[f"{name}/codes"])
    qs = jnp.asarray(inp[f"{name}/queries"])
    for sel, pack in combos:
        d, i = hamming_topk_grouped_sharded(codes, qs, l, mesh,
                                            use_kernel=False, select=sel,
                                            pack=pack)
        out[f"{name}/{sel}/{pack}/d"] = np.asarray(d)
        out[f"{name}/{sel}/{pack}/i"] = np.asarray(i)
codes, q = jnp.asarray(inp["single/codes"]), jnp.asarray(inp["single/q"])
for sel, pack in spec["single"]:
    d, i = hamming_topk_sharded(codes, q, 24, mesh, use_kernel=False,
                                select=sel, pack=pack)
    out[f"single/{sel}/{pack}/d"] = np.asarray(d)
    out[f"single/{sel}/{pack}/i"] = np.asarray(i)


def state(prefix, idx):
    # copies: the index mutates its arrays in place afterwards
    out[prefix + "seeds"] = np.array([f.seed for f in idx.families])
    out[prefix + "u"] = np.stack([np.asarray(f.u) for f in idx.families])
    out[prefix + "v"] = np.stack([np.asarray(f.v) for f in idx.families])
    out[prefix + "x"] = np.array(idx.x_np)
    out[prefix + "codes"] = np.stack(idx.codes)
    out[prefix + "active"] = np.array(idx.active)
    out[prefix + "ids"] = np.array(idx.ids_np)
    out[prefix + "next_id"] = np.int64(idx._next_id)


def answers(prefix, idx, ws, l, topk):
    r = idx.query_scan_batch(ws, l=l, topk=topk, mesh=mesh)
    d, i = idx.scan_table_topk(ws, l=l, mesh=mesh)
    out[prefix + "ids_topk"] = r.ids_topk
    out[prefix + "margins_topk"] = r.margins_topk
    out[prefix + "hits"] = r.table_hits
    out[prefix + "cand"] = np.concatenate(r.candidates)
    out[prefix + "cand_len"] = np.array([c.size for c in r.candidates])
    out[prefix + "lists_d"], out[prefix + "lists_i"] = d, i


if "index" in spec:
    ws = inp["index/ws"]
    mt = MultiTableIndex(IndexConfig(**spec["index"],
                                     use_kernels=False)).fit(inp["index/x"])
    state("index/state/", mt)
    out["index/qcodes"] = np.asarray(bq.hash_queries_all(mt.families, ws))
    answers("index/before/", mt, ws, spec["l"], spec["topk"])
    mt.delete(np.arange(299))                     # 299/597 > 0.5
    assert mt.compactions == 1, mt.compactions
    answers("index/after/", mt, ws, spec["l"], spec["topk"])
    svc = HashQueryService(mt, max_batch=8, mode="scan", scan_l=spec["l"],
                           mesh=mesh)
    got = svc.query_batch(ws)
    out["index/service/ids"] = np.array([r.index for r in got])
    out["index/service/margins"] = np.array([r.margin for r in got])
if "lsm" in spec:
    lx, lws = inp["lsm/x"], inp["lsm/ws"]
    n0 = spec["lsm_n0"]
    j = LSMMultiTableIndex(IndexConfig(**spec["lsm"],
                                       use_kernels=False)).fit(lx[:n0])
    state("lsm/state/", j)
    j.delete(inp["lsm/del_base"])
    j.insert(lx[n0:])
    j.delete(inp["lsm/del_delta"])
    out["lsm/codes_after"] = np.stack(j.codes)
    out["lsm/qcodes"] = np.asarray(bq.hash_queries_all(j.families, lws))
    answers("lsm/", j, lws, spec["lsm_l"], spec["lsm_topk"])
np.savez(sys.argv[2], **out)
"""


def _rand_u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint32)


def _inputs(shards):
    """(numpy inputs, JSON spec) of one shard count's JAX subprocess."""
    rng = np.random.default_rng(100 + shards)
    inp, cases = {}, []
    for name, ((g, n, b, w, l), combos) in CASES.items():
        codes = (np.zeros((g, n, w), np.uint32) if name == "ties"
                 else _rand_u32(rng, (g, n, w)))
        queries = _rand_u32(rng, (g, b, w))
        if name == "pad_tail":
            codes[:, -20:] = 0
            codes[:, -20:, 0] = 1 << rng.integers(0, 32, 20, dtype=np.uint32)
            queries[:] = 0
        inp[f"{name}/codes"] = codes
        inp[f"{name}/queries"] = queries
        cases.append((name, l, combos))
    inp["single/codes"] = _rand_u32(rng, (SINGLE_N, 2))
    inp["single/q"] = _rand_u32(rng, (2,))
    spec = {"shards": shards, "cases": cases, "single": COMBOS}
    if shards == 4:
        corpus = tiny1m_like(n_labeled=700, n_unlabeled=0, d=32, classes=5,
                             seed=0)
        inp["index/x"] = corpus.x[:INDEX_ROWS]
        inp["index/ws"] = np.random.default_rng(1).normal(
            size=(8, corpus.x.shape[1])).astype(np.float32)
        spec.update(index=INDEX_CFG, l=INDEX_L, topk=INDEX_TOPK)
    else:
        inp.update(_lsm_inputs())
        spec.update(lsm=LSM_CFG, lsm_n0=LSM_N0, lsm_l=LSM_L,
                    lsm_topk=LSM_TOPK)
    return inp, spec


def _lsm_inputs():
    corpus = tiny1m_like(n_labeled=400, n_unlabeled=0, d=24, classes=5,
                         seed=0)
    rng = np.random.default_rng(7)
    return {"lsm/x": corpus.x,
            "lsm/ws": rng.normal(size=(16, corpus.x.shape[1])).astype(
                np.float32),
            "lsm/del_base": np.sort(rng.choice(LSM_N0, 40, replace=False)),
            "lsm/del_delta": LSM_N0 + np.sort(
                rng.choice(corpus.x.shape[0] - LSM_N0, 10, replace=False))}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{shards: (inputs, JAX outputs)}; both subprocesses run together."""
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    procs, inputs = {}, {}
    for shards in (2, 4):
        inp, spec = _inputs(shards)
        inputs[shards] = inp
        np.savez(tmp / f"in{shards}.npz", **inp)
        procs[shards] = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_JAX_SCRIPT),
             str(tmp / f"in{shards}.npz"), str(tmp / f"out{shards}.npz"),
             json.dumps(spec)],
            env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count="
                     f"{shards}"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {}
    for shards, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        runs[shards] = (inputs[shards],
                        dict(np.load(tmp / f"out{shards}.npz")))
    return runs


def _cpu_mesh(shards):
    return make_mesh((shards,), ("data",), devices=["cpu"] * shards)


def _t(a):
    return from_numpy_u32(a)


# -- the mesh ----------------------------------------------------------------

def test_make_mesh_rules():
    mesh = _cpu_mesh(3)
    assert mesh.shape == {"data": 3} and mesh.axis_names == ("data",)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh == Mesh(["cpu"] * 3, "data") and hash(mesh) == hash(
        Mesh(["cpu"] * 3, ("data",)))
    assert mesh != _cpu_mesh(2) and shard_count(mesh, "data") == 3
    # devices=None takes CUDA cards only: more than exist raises
    with pytest.raises(RuntimeError):
        make_mesh((torch.cuda.device_count() + 1,), ("data",))
    with pytest.raises(ValueError):
        make_mesh((2,), ("data",), devices=["cpu"])
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(TypeError):
        shard_count(object(), "data")
    with pytest.raises(ValueError):
        shard_count(mesh, "model")


def test_cuda_mesh_needs_a_usable_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_mesh((2,), ("data",), devices=["cuda:0", "cuda:0"])


# -- the building blocks -----------------------------------------------------

@pytest.mark.parametrize("n_seg,l,depth,dead_frac", [
    (50, 8, 32, 0.3), (50, 8, 64, 0.9), (200, 16, 48, 0.1), (7, 5, 12, 0.5)])
def test_drop_tombstones_matches_jax(n_seg, l, depth, dead_frac):
    """Lex-sorted lists (ties, sentinel tails) filtered by a liveness mask:
    the port's result equals the JAX package's bit for bit."""
    rng = np.random.default_rng(n_seg + depth)
    d = rng.integers(0, 6, (3, 4, depth)).astype(np.int32)
    i = rng.integers(0, n_seg, (3, 4, depth)).astype(np.int32)
    sent = rng.random((3, 4, depth)) < 0.15
    d[sent], i[sent] = search.DIST_SENTINEL, -1
    order = np.lexsort((i, d), axis=-1)
    d = np.take_along_axis(d, order, -1)
    i = np.take_along_axis(i, order, -1)
    active = rng.random(n_seg) >= dead_frac
    jd, ji = j_drop(jnp.asarray(d), jnp.asarray(i), jnp.asarray(active), l)
    td, ti = search.drop_tombstones_topk(torch.from_numpy(d),
                                         torch.from_numpy(i),
                                         torch.from_numpy(active), l)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("pack,w,rows", [
    ("16", 2, 0x8000), ("8", 1, 100), ("16", 2, 0x8001),
    ("16", 1023, 50), ("none", 2, 100)])
def test_narrow_widen_round_trip(pack, w, rows):
    """The gather's int16 packing: distances narrow while 32·W < 0x7FFF,
    ids while rows - 1 <= 0x7FFF; widening restores the int32 values, the
    DIST_SENTINEL and each shard's global offset."""
    rng = np.random.default_rng(rows)
    shards = 3
    d = torch.from_numpy(rng.integers(0, 32 * w + 1, (shards, 2, 5),
                                      dtype=np.int32))
    i = torch.from_numpy(rng.integers(0, rows, (shards, 2, 5),
                                      dtype=np.int32))
    d[:, :, -1], i[:, :, -1] = search.DIST_SENTINEL, -1
    nd, ni, pk_d, pk_i = search._narrow_gather(d, i, pack, w, rows)
    assert pk_d == (pack != "none" and 32 * w < 0x7FFF)
    assert pk_i == (pack != "none" and rows - 1 <= 0x7FFF)
    assert nd.dtype == (torch.int16 if pk_d else torch.int32)
    assert ni.dtype == (torch.int16 if pk_i else torch.int32)
    wd, wi = search._widen_gather(nd, ni, pk_d, pk_i, rows)
    offsets = (torch.arange(shards, dtype=torch.int32) * rows).view(-1, 1, 1)
    assert torch.equal(wd, d)
    assert torch.equal(wi, torch.where(i < 0, -1, i + offsets))


# -- against the JAX package: the scans --------------------------------------

@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("select,pack", COMBOS)
def test_grouped_sharded_matches_jax(jax_runs, shards, select, pack):
    """hamming_topk_grouped_sharded on S co-located CPU shards equals the
    JAX package's on S forced host devices, and the single-device
    ``ops.hamming_topk_grouped``, bit for bit."""
    inp, out = jax_runs[shards]
    mesh = _cpu_mesh(shards)
    ran = 0
    for name, ((_, n, _, _, l), combos) in CASES.items():
        if (select, pack) not in combos:
            continue
        ran += 1
        codes, qs = _t(inp[f"{name}/codes"]), _t(inp[f"{name}/queries"])
        d, i = search.hamming_topk_grouped_sharded(codes, qs, l, mesh,
                                                   select=select, pack=pack)
        key = f"{name}/{select}/{pack}"
        assert np.array_equal(d.numpy(), out[key + "/d"]), key
        assert np.array_equal(i.numpy(), out[key + "/i"]), key
        want = ops.hamming_topk_grouped(codes, qs, l, select=select,
                                        pack=pack)
        assert torch.equal(d, want[0]) and torch.equal(i, want[1]), key
        if l > n:
            assert (d.numpy()[..., n:] == search.DIST_SENTINEL).all()
            assert (i.numpy()[..., n:] == -1).all()
    assert ran >= 3


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("select,pack", COMBOS)
def test_single_query_sharded_matches_jax(jax_runs, shards, select, pack):
    inp, out = jax_runs[shards]
    codes, q = _t(inp["single/codes"]), _t(inp["single/q"])
    d, i = search.hamming_topk_sharded(codes, q, 24, _cpu_mesh(shards),
                                       select=select, pack=pack)
    key = f"single/{select}/{pack}"
    assert np.array_equal(d.numpy(), out[key + "/d"])
    assert np.array_equal(i.numpy(), out[key + "/i"])
    want = ops.hamming_topk(codes, q, 24, select=select, pack=pack)
    assert torch.equal(d, want[0]) and torch.equal(i, want[1])


def test_sharded_scan_takes_a_per_shard_layout():
    """The serving paths' cached layout (shard_rows) gives the answer of
    the full tensor; the single-query scan refuses rows that do not divide
    the shards, as under shard_map."""
    rng = np.random.default_rng(3)
    codes = _rand_u32(rng, (2, 101, 2))
    qs = _t(_rand_u32(rng, (2, 3, 2)))
    mesh = _cpu_mesh(3)
    parts = search.shard_rows(codes, mesh)
    assert [p.shape[1] for p in parts] == [34] * 3
    want = ops.hamming_topk_grouped(_t(codes), qs, 20)
    got = search.hamming_topk_grouped_sharded(parts, qs, 20, mesh,
                                              n_valid=101)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="divide"):
        search.hamming_topk_sharded(_t(codes[0]), qs[0, 0], 4, mesh)
    with pytest.raises(ValueError, match="shards"):
        search.hamming_topk_grouped_sharded(parts[:2], qs, 4, mesh)


# -- against the JAX package: the index, its service, the LSM index ----------

def _carry(prefix, out, config, cls=MultiTableIndex):
    specs = [{"kind": "seeded_bh", "seed": int(s), "u": u, "v": v}
             for s, u, v in zip(out[prefix + "seeds"], out[prefix + "u"],
                                out[prefix + "v"])]
    return interop.index_from_numpy(
        config, specs, out[prefix + "x"], list(out[prefix + "codes"]),
        out[prefix + "active"], out[prefix + "ids"],
        int(out[prefix + "next_id"]), device="cpu", cls=cls)


def _margin_tol(x_by_id, ws, ids, want):
    """rtol 1e-5 plus the float32 rounding bound of |w . x| / ||w||."""
    terms = np.abs(x_by_id[np.clip(ids, 0, None)] * ws[:, None, :]).sum(-1)
    bound = (ws.shape[1] + 8) * 2.0 ** -23 * terms / np.linalg.norm(
        ws, axis=1, keepdims=True)
    return 1e-5 * np.abs(np.where(np.isfinite(want), want, 0)) + bound


def _same_queries(tidx, ws, jax_qcodes):
    tq = to_numpy_u32(tbq.hash_queries_all(tidx.families, ws))
    ratios = sign_flip_ratios(torch.from_numpy(ws),
                              [(f.u, f.v) for f in tidx.families],
                              from_numpy_u32(tq), from_numpy_u32(jax_qcodes))
    assert (ratios <= 1.0).all()
    same = (tq == jax_qcodes).all(axis=(0, 2))
    assert same.mean() >= 0.9
    return same


def _assert_like_jax(prefix, out, tidx, ws, l, topk, same, x_by_id, mesh):
    """The port's mesh answers against the JAX package's mesh answers."""
    res = tidx.query_scan_batch(ws, l=l, topk=topk, mesh=mesh)
    d, i = tidx.scan_table_topk(ws, l=l, mesh=mesh)
    assert np.array_equal(d[:, same], out[prefix + "lists_d"][:, same])
    assert np.array_equal(i[:, same], out[prefix + "lists_i"][:, same])
    cands = np.split(out[prefix + "cand"], np.cumsum(out[prefix + "cand_len"])
                     [:-1])
    for q in np.flatnonzero(same):
        assert np.array_equal(res.candidates[q], cands[q])
    if same.all():
        assert np.array_equal(res.table_hits, out[prefix + "hits"])
    _assert_answers_close(res.ids_topk[same], res.margins_topk[same],
                          out[prefix + "ids_topk"][same],
                          out[prefix + "margins_topk"][same], x_by_id,
                          ws[same])
    return res


def _assert_answers_close(ids_t, m_t, ids_j, m_j, x_by_id, ws):
    """(B, k) answers of the two packages: margins within the tolerance,
    ids equal but where two margins tie within it."""
    assert np.array_equal(np.isinf(m_t), np.isinf(m_j))
    fin = np.isfinite(m_j)
    tol = _margin_tol(x_by_id, ws, ids_j, m_j)
    assert np.all(np.abs(m_t - m_j)[fin] <= tol[fin])
    differ = ids_t != ids_j
    alt = _margin_tol(x_by_id, ws, ids_t, m_t)
    assert np.all(np.abs(m_t - m_j)[differ] <= tol[differ] + alt[differ])


def _assert_scan_equal(a, b):
    """Two port answers (mesh and no mesh), everything bit for bit."""
    assert np.array_equal(a.ids, b.ids)
    assert np.array_equal(a.margins, b.margins)
    assert np.array_equal(a.nonempty, b.nonempty)
    assert np.array_equal(a.table_hits, b.table_hits)
    assert np.array_equal(a.ids_topk, b.ids_topk)
    assert np.array_equal(a.margins_topk, b.margins_topk)
    for ca, cb in zip(a.candidates, b.candidates):
        assert np.array_equal(ca, cb)


def test_sharded_query_scan_batch_matches_jax(jax_runs):
    """The counterpart of tests/test_distribution.py::
    test_sharded_query_scan_batch on a JAX index carried across: 597 rows,
    3 tables, 4 shards; before and after >= 50% delete churn with
    auto-compaction, and through the scan-mode service."""
    inp, out = jax_runs[4]
    ws = inp["index/ws"]
    mesh = _cpu_mesh(4)
    tidx = _carry("index/state/", out, IndexConfig(**INDEX_CFG))
    assert np.array_equal(np.stack(tidx.codes), out["index/state/codes"])
    same = _same_queries(tidx, ws, out["index/qcodes"])
    x_by_id = np.asarray(inp["index/x"])
    for when in ("before", "after"):
        if when == "after":
            tidx.delete(np.arange(299))                # 299/597 > 0.5
            assert tidx.compactions == 1
        res = _assert_like_jax(f"index/{when}/", out, tidx, ws, INDEX_L,
                               INDEX_TOPK, same, x_by_id, mesh)
        _assert_scan_equal(res, tidx.query_scan_batch(ws, l=INDEX_L,
                                                      topk=INDEX_TOPK))
    assert (res.ids >= 299).all()                      # stable ids survive
    svc = HashQueryService(tidx, max_batch=8, mode="scan", scan_l=INDEX_L,
                           mesh=mesh)
    got = svc.query_batch(ws)
    want = tidx.query_scan_batch(ws, l=INDEX_L)
    assert [r.index for r in got] == want.ids.tolist()
    assert [r.margin for r in got] == want.margins.tolist()
    assert svc.stats()["requests"] == 8
    _assert_answers_close(
        np.array([[r.index] for r in got])[same],
        np.array([[r.margin] for r in got], np.float32)[same],
        out["index/service/ids"][same, None],
        out["index/service/margins"][same, None], x_by_id, ws[same])


def _lsm_pair(out, inp):
    """The port LSM index from the JAX LSM's fit state, then the JAX
    subprocess's script: base tombstones, a delta, delta tombstones."""
    tidx = _carry("lsm/state/", out, IndexConfig(**LSM_CFG),
                  cls=LSMMultiTableIndex)
    tidx.delete(inp["lsm/del_base"])
    tidx.insert(inp["lsm/x"][LSM_N0:])
    tidx.delete(inp["lsm/del_delta"])
    return tidx


def test_lsm_mesh_matches_jax(jax_runs):
    """The LSM index with tombstones in its base and rows in its delta:
    the port's mesh lists and answers equal the JAX LSM's mesh ones (2
    shards), and the port's own without a mesh."""
    inp, out = jax_runs[2]
    tidx = _lsm_pair(out, inp)
    assert tidx.segments()["delta_rows"] > 0
    assert not tidx.active[:LSM_N0].all() and not tidx.active[LSM_N0:].all()
    got = np.stack(tidx.codes)
    ratios = sign_flip_ratios(torch.from_numpy(np.asarray(tidx.x_np)),
                              [(f.u, f.v) for f in tidx.families],
                              from_numpy_u32(got),
                              from_numpy_u32(out["lsm/codes_after"]))
    assert (ratios <= 1.0).all()
    assert np.array_equal(got, out["lsm/codes_after"]), "a near-zero bit"
    ws = inp["lsm/ws"]
    same = _same_queries(tidx, ws, out["lsm/qcodes"])
    res = _assert_like_jax("lsm/", out, tidx, ws, LSM_L, LSM_TOPK, same,
                           np.asarray(inp["lsm/x"]), _cpu_mesh(2))
    _assert_scan_equal(res, tidx.query_scan_batch(ws, l=LSM_L,
                                                  topk=LSM_TOPK))


# -- the port's mesh against the port without one ----------------------------

@pytest.fixture(scope="module")
def lsm_corpus():
    return tiny1m_like(n_labeled=400, n_unlabeled=0, d=24, classes=5, seed=0)


def _assert_mesh_like_no_mesh(idx, ws, mesh, l=9, topk=3):
    a = idx.query_scan_batch(ws, l=l, topk=topk, mesh=mesh)
    b = idx.query_scan_batch(ws, l=l, topk=topk)
    _assert_scan_equal(a, b)
    da, ia = idx.scan_table_topk(ws, l=l, mesh=mesh)
    db, ib = idx.scan_table_topk(ws, l=l)
    assert np.array_equal(da, db) and np.array_equal(ia, ib)


@pytest.mark.parametrize("shards", [2, 3])
def test_lsm_mesh_across_fold_and_refresh(lsm_corpus, shards):
    """Base tombstones (the overscan and drop_tombstones_topk) and delta
    rows, then a fold and a refresh swap, each of which installs a
    single-device base by hand: a mesh query afterwards rebuilds the
    sharded layout and answers like no mesh, l > n included."""
    x = lsm_corpus.x
    rng = np.random.default_rng(shards)
    ws = rng.normal(size=(12, x.shape[1])).astype(np.float32)
    mesh = _cpu_mesh(shards)
    idx = LSMMultiTableIndex(IndexConfig(**LSM_CFG), device="cpu").fit(
        x[:250])
    idx.delete(np.sort(rng.choice(250, 60, replace=False)))
    idx.insert(x[250:])
    idx.delete(np.array([255, 300, 399]))
    _assert_mesh_like_no_mesh(idx, ws, mesh)
    _assert_mesh_like_no_mesh(idx, ws, mesh, l=512, topk=5)   # l > n
    rebuilds = idx.scan_state_rebuilds
    idx.compact()                                      # the fold
    assert idx.segments()["delta_rows"] == 0
    _assert_mesh_like_no_mesh(idx, ws, mesh)
    assert idx.scan_state_rebuilds > rebuilds
    new = idx.insert(x[:30])
    idx.delete(new[[0, 5, 7]])
    svc = HashQueryService(idx, mode="scan", scan_l=9, mesh=mesh)
    assert svc.refresh()                               # the generation swap
    assert idx.generation == 1
    _assert_mesh_like_no_mesh(idx, ws, mesh)
    plain = HashQueryService(idx, mode="scan", scan_l=9)
    assert [r.index for r in svc.query_batch(ws)] == [
        r.index for r in plain.query_batch(ws)]


def test_router_mesh_equals_no_mesh(lsm_corpus):
    """Each replica's scan row-sharded over the mesh: the router's answer
    equals its answer without one, after inserts and deletes."""
    x = lsm_corpus.x
    router = ShardReplicaRouter(IndexConfig(**{**LSM_CFG, "lsm_auto": True}),
                                shards=2, replicas=2, deadline_ms=5000.0,
                                device="cpu").fit(x[:300])
    try:
        router.insert(x[300:])
        router.delete(np.arange(0, 400, 7))
        ws = np.random.default_rng(5).normal(size=(8, x.shape[1])).astype(
            np.float32)
        mesh = _cpu_mesh(3)
        a = router.query_scan_batch(ws, l=9, topk=4, mesh=mesh)
        b = router.query_scan_batch(ws, l=9, topk=4)
        assert a.coverage == b.coverage == 1.0
        _assert_scan_equal(a, b)
        with pytest.raises(TypeError):
            router.query_scan_batch(ws, mesh=object())
    finally:
        router.close()


def test_services_over_a_mesh(lsm_corpus):
    """The scan-mode service and the async front end with a mesh answer as
    without one; a mesh needs mode='scan'."""
    x = lsm_corpus.x
    idx = MultiTableIndex(IndexConfig(**LSM_CFG), device="cpu").fit(x)
    mesh = _cpu_mesh(4)
    ws = np.random.default_rng(9).normal(size=(10, x.shape[1])).astype(
        np.float32)
    want = HashQueryService(idx, mode="scan", scan_l=9).query_batch(ws)
    got = HashQueryService(idx, mode="scan", scan_l=9, mesh=mesh,
                           max_batch=4).query_batch(ws)
    assert [(r.index, r.margin) for r in got] == [
        (r.index, r.margin) for r in want]
    asvc = AsyncHashQueryService(idx, mode="scan", scan_l=9, mesh=mesh,
                                 deadline_ms=1.0)
    try:
        res = [f.result(timeout=60) for f in [asvc.submit(w) for w in ws]]
    finally:
        asvc.close()
    assert [(r.index, r.margin) for r in res] == [
        (r.index, r.margin) for r in want]
    with pytest.raises(ValueError, match="scan"):
        HashQueryService(idx, mode="probe", mesh=mesh)
    with pytest.raises(ValueError):
        HashQueryService(idx, mode="scan", mesh=mesh, shard_axis="model")


def test_layout_cache_uploads_once_per_mesh(lsm_corpus):
    """Two consecutive queries on one mesh upload nothing the second time;
    a changed mesh rebuilds once; an equal mesh object reuses the layout."""
    x = lsm_corpus.x
    ws = np.random.default_rng(2).normal(size=(4, x.shape[1])).astype(
        np.float32)
    for cls in (MultiTableIndex, LSMMultiTableIndex):
        idx = cls(IndexConfig(**LSM_CFG), device="cpu").fit(x)
        idx.query_scan_batch(ws, l=9, mesh=_cpu_mesh(2))
        st = idx.stats()
        idx.query_scan_batch(ws, l=9, mesh=_cpu_mesh(2))
        idx.scan_table_topk(ws, l=9, mesh=_cpu_mesh(2))
        assert idx.stats()["device_uploads"] == st["device_uploads"], cls
        assert idx.stats()["scan_state_rebuilds"] == st[
            "scan_state_rebuilds"]
        idx.query_scan_batch(ws, l=9, mesh=_cpu_mesh(3))
        idx.query_scan_batch(ws, l=9, mesh=_cpu_mesh(3))
        assert idx.stats()["scan_state_rebuilds"] == st[
            "scan_state_rebuilds"] + 1, cls
        assert idx.stats()["device_uploads"] == st["device_uploads"] + 1


def test_a_failed_shard_launch_raises(lsm_corpus, monkeypatch):
    """A shard whose scan fails (a wrapper raising RuntimeError, as a failed
    build or launch does) makes the mesh query raise: on the index, and on
    the router, which neither degrades the answer nor takes a replica
    down."""
    x = lsm_corpus.x
    ws = np.random.default_rng(4).normal(size=(4, x.shape[1])).astype(
        np.float32)
    idx = MultiTableIndex(IndexConfig(**LSM_CFG), device="cpu").fit(x)
    router = ShardReplicaRouter(IndexConfig(**LSM_CFG), shards=2,
                                replicas=2, deadline_ms=5000.0,
                                device="cpu").fit(x)
    calls = []

    def broken(codes, *a, **k):
        calls.append(codes.shape[1])
        raise RuntimeError("topk_hist launch failed: CUDA error 98")

    try:
        monkeypatch.setattr(ops, "hamming_topk_hist", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            idx.query_scan_batch(ws, l=9, mesh=_cpu_mesh(2))
        with pytest.raises(RuntimeError, match="launch failed"):
            router.query_scan_batch(ws, l=9, mesh=_cpu_mesh(2))
        st = router.stats()
        assert st["replica_downs"] == 0 and st["degraded_answers"] == 0
        assert calls and max(calls) <= 200      # shard-sized scans
        monkeypatch.undo()
        _assert_scan_equal(
            router.query_scan_batch(ws, l=9, topk=2, mesh=_cpu_mesh(2)),
            router.query_scan_batch(ws, l=9, topk=2))
    finally:
        router.close()
