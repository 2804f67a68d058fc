"""The port's dry-run accounting on the CPU against the JAX package's:
the sharding rules, the input and cache specs, the parameter counts, the
FLOPs of reduced steps against the compiled-HLO count, and the account's
own pieces (the op counter, peak live bytes, the ring model, whole
records of full-size cells on the meta device).

Tolerances:
- exact: every partition spec (the port's tuples against JAX's
  ``PartitionSpec``s over a ``jax.sharding.AbstractMesh``), input and
  cache shapes and dtypes, ``count_params``, the six-matmul count, the
  peak of a hand-built sequence, the ring model's wire bytes;
- FLOPs of the reduced train (remat), prefill and decode steps of a
  dense (qwen3-1.7b), a MoE (deepseek-moe-16b) and an SSD (mamba2-780m)
  arch: within 2% of ``repro.launch.hlo_stats.analyze_hlo`` on the same
  step compiled for one CPU device.  Measured: equal for the dense and
  MoE steps and the SSD prefill and decode; the SSD train step 0.31%
  below, one term by design: the reference's ``ssd_chunked`` contracts
  its three-operand intra-chunk products with einsums, whose transposes
  in backward are dots, while the port forms them as pairwise products
  (``models/ssm.py``), whose gradients autograd takes as elementwise
  products and sums, which no matmul formula counts.  The term is not
  taken out: what is left is within 2% with it.
"""
import ast
import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch import hlo_stats  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro.train import step as JSTEP  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig, cells_for  # noqa
from repro_torch.launch import analysis, dryrun, op_stats  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.launch.mesh import (NODE_SIZE, make_debug_mesh,  # noqa
                                     make_production_mesh)
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.train import step as TSTEP  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ALL = sorted(jreg.ARCHS)
MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True),
          "debug": make_debug_mesh(8, 2)}


def abstract(mesh):
    return AbstractMesh(mesh.sizes, mesh.axis_names)


def spec(p) -> tuple:
    """A JAX PartitionSpec or NamedSharding as the port's tuple."""
    return tuple(getattr(p, "spec", p))


# -- sharding rules and specs --------------------------------------------------

@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_spec_for_every_leaf_matches_jax(mesh_name):
    mesh = MESHES[mesh_name]
    for arch in ALL:
        jcfg, tcfg = jreg.ARCHS[arch], treg.ARCHS[arch]
        rules = TR.param_rules(tcfg)
        assert rules == JR.param_rules(jcfg)
        jleaves = jax.tree.leaves(JT.model_spec(jcfg), is_leaf=JL.is_spec)
        tleaves = []
        TL.tree_map(tleaves.append, TT.model_spec(tcfg))
        assert [s.shape for s in jleaves] == [s.shape for s in tleaves]
        for js, ts in zip(jleaves, tleaves):
            want = JR.spec_for(js.axes, rules, mesh, js.shape)
            assert TR.spec_for(ts.axes, rules, mesh, ts.shape) == spec(want)
        # the tree form, against JAX's NamedShardings over an abstract mesh
        got = TR.param_shardings(
            TL.logical_axes(TT.model_spec(tcfg)), rules, mesh,
            TL.abstract_params(TT.model_spec(tcfg), torch.bfloat16))
        want = JR.param_shardings(
            JL.logical_axes(JT.model_spec(jcfg)), rules, abstract(mesh),
            JL.abstract_params(JT.model_spec(jcfg), jnp.bfloat16))
        assert _flat_specs(got) == [spec(s) for s in jax.tree.leaves(want)]


def _flat_specs(tree) -> list:
    """The spec tuples of a tree of specs, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_specs(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _flat_specs(t)]
    return [tree]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_matches_jax(mesh_name):
    mesh = MESHES[mesh_name]
    for b in (1, 2, 8, 16, 24, 32, 128, 256, 512, 1000):
        for ndim in (1, 2, 3):
            for seq_dim, seq_len in ((None, 0), (1, 16), (1, 100),
                                     (1, 4096), (1, 524288)):
                if seq_dim is not None and seq_dim >= ndim:
                    continue
                want = JR.batch_spec(mesh, b, ndim, seq_dim, seq_len)
                assert TR.batch_spec(mesh, b, ndim, seq_dim, seq_len) \
                    == spec(want), (b, ndim, seq_dim, seq_len)
    assert TR.data_axes(mesh) == JR.data_axes(mesh)


def _port_layers_as_jax(jcaches, cfg):
    """The JAX cache tree's per-layer slices in the port's layer order:
    prelude, the stacked body repeat by repeat, tail."""
    prelude, unit, n_rep, tail = JT.plan_segments(cfg)
    out = list(jcaches.get("prelude", []))
    for r in range(n_rep):
        out += [jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            x.shape[1:], x.dtype), jcaches["body"][i])
            for i in range(len(unit))]
    return out + list(jcaches.get("tail", []))


@pytest.mark.parametrize("arch", ALL)
def test_inputs_and_caches_match_jax(arch):
    jcfg, tcfg = jreg.ARCHS[arch], treg.ARCHS[arch]
    dt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}

    def same(t, j):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).replace("torch.", "") == str(jnp.dtype(j.dtype))
        assert t.device.type == "meta"

    for shape in cells_for(tcfg):
        jshape = jbase.SHAPES[shape.name]
        if shape.kind == "decode":
            (ti, tp), (ji, jp) = (TSP.decode_inputs(tcfg, shape),
                                  JSP.decode_inputs(jcfg, jshape))
            same(ti, ji)
            same(tp, jp)
            jc = JSP.cache_abstract(jcfg, shape.global_batch, shape.seq_len)
            tc = TSP.cache_abstract(tcfg, shape.global_batch, shape.seq_len)
            want = _port_layers_as_jax(jc, jcfg)
            assert len(tc) == len(want)
            for t_layer, j_layer in zip(tc, want):
                assert sorted(t_layer) == sorted(j_layer)
                for k in t_layer:
                    same(t_layer[k], j_layer[k])
            for mesh in MESHES.values():
                am = abstract(mesh)
                # the same leaves (JAX's stacked ones) through both
                for leaf in jax.tree.leaves(jc):
                    assert TSP._cache_leaf_spec(
                        mesh, leaf, shape.global_batch) == spec(
                        JSP._cache_leaf_spec(am, leaf, shape.global_batch))
                assert TSP.logits_sharding(mesh, tcfg, shape.global_batch) \
                    == spec(JSP.logits_sharding(am, jcfg,
                                                shape.global_batch))
            continue
        fn_t, fn_j = ((TSP.train_inputs, JSP.train_inputs)
                      if shape.kind == "train"
                      else (TSP.prefill_inputs, JSP.prefill_inputs))
        ti, ji = fn_t(tcfg, shape), fn_j(jcfg, jshape)
        assert sorted(ti) == sorted(ji)
        for k in ti:
            same(ti[k], ji[k])
        for mesh in MESHES.values():
            got = TSP.train_input_shardings(mesh, tcfg, shape)
            want = JSP.train_input_shardings(abstract(mesh), jcfg, jshape)
            assert got == {k: spec(v) for k, v in want.items()}
    assert TSP.act_dtype(tcfg) == getattr(torch, str(jnp.dtype(
        dt[jcfg.dtype])))


def _jax_train_overrides() -> dict:
    """TRAIN_OVERRIDES as the JAX dry-run's source states them (importing
    that module sets XLA_FLAGS for the whole process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "TRAIN_OVERRIDES":
            return {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                          for kw in v.keywords}
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no TRAIN_OVERRIDES")


def _jax_count_params(cfg):
    """The JAX dry-run's count_params, run where its module's import
    cannot leave XLA_FLAGS behind."""
    saved = {k: os.environ.get(k) for k in ("XLA_FLAGS",
                                            "REPRO_DRYRUN_DEVICES")}
    os.environ["REPRO_DRYRUN_DEVICES"] = "1"
    try:
        from repro.launch import dryrun as JD
        return JD.count_params(cfg)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_count_params_and_overrides_match_jax():
    assert dryrun.TRAIN_OVERRIDES == _jax_train_overrides()
    for arch in ALL:
        assert dryrun.count_params(treg.ARCHS[arch]) == \
            _jax_count_params(jreg.ARCHS[arch])


# -- FLOPs against the compiled HLO ------------------------------------------

B, S = 2, 64


def _jax_flops(cfg, kind: str, b: int = B, s: int = S) -> float:
    dtype = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    absp = JL.abstract_params(JT.model_spec(cfg), dtype)
    shape = jbase.ShapeConfig("t", s, b, kind)
    if kind == "train":
        kw = dict(_jax_train_overrides().get(cfg.name, {}))
        opt = JO.AdamWConfig(moment_dtype=kw.pop("moment_dtype", "float32"))
        accum = jnp.bfloat16 if kw.pop("accum_dtype", "float32") == \
            "bfloat16" else jnp.float32
        step = JSTEP.make_train_step(cfg, opt, remat=True, accum_dtype=accum,
                                     num_microbatches=kw.pop(
                                         "num_microbatches", 1))
        opt_abs = jax.eval_shape(lambda p: JO.init_opt_state(p, opt), absp)
        lowered = jax.jit(step).lower(absp, opt_abs,
                                      JSP.train_inputs(cfg, shape))
    elif kind == "prefill":
        lowered = jax.jit(JE.make_prefill_step(cfg, cache_len=s)).lower(
            absp, JSP.prefill_inputs(cfg, shape))
    else:
        inp, pos = JSP.decode_inputs(cfg, shape)
        lowered = jax.jit(JE.make_serve_step(cfg)).lower(
            absp, JSP.cache_abstract(cfg, b, s), inp, pos)
    return hlo_stats.analyze_hlo(lowered.compile().as_text(), 1, 1)["flops"]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b",
                                  "mamba2-780m"])
def test_reduced_step_flops_match_the_hlo_count(arch):
    jcfg, tcfg = jreg.reduced(jreg.ARCHS[arch]), treg.REDUCED[arch]
    for kind in ("train", "prefill", "decode"):
        counts = dryrun.count_step(tcfg, ShapeConfig("t", S, B, kind))
        got = sum(counts["flops_by_dtype"].values())
        want = _jax_flops(jcfg, kind)
        assert abs(got - want) <= 0.02 * want, (kind, got, want)
        if arch != "mamba2-780m" or kind != "train":
            assert got == want, (kind, got, want)


def test_reduced_prefill_at_two_chunks_flops_match_the_hlo_count():
    """At S = 1,024 the attention runs two 512-token chunks each way
    (the JAX package's two nested scans, whose trips the HLO count
    multiplies in): the port's chunked form does the same work, masked
    chunks included."""
    jcfg, tcfg = jreg.reduced(jreg.ARCHS["qwen3-1.7b"]), \
        treg.REDUCED["qwen3-1.7b"]
    counts = dryrun.count_step(tcfg, ShapeConfig("t", 1024, 1, "prefill"))
    got = sum(counts["flops_by_dtype"].values())
    assert got == _jax_flops(jcfg, "prefill", b=1, s=1024)


# -- the counter ---------------------------------------------------------------

@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_counter_counts_six_chained_matmuls_exactly(device):
    x = torch.zeros((128, 128), device=device)
    ws = [torch.zeros((128, 128), device=device) for _ in range(6)]
    with op_stats.OpCounter() as c:
        for w in ws:
            x = x @ w
    assert c.flops == 6 * 2 * 128 ** 3
    assert dict(c.flops_by_dtype) == {"float32": 6 * 2 * 128 ** 3}
    assert c.launches == 6
    # each product reads two 64 KiB operands and writes one
    assert c.eager_bytes == 6 * 3 * 128 * 128 * 4


def test_counter_peak_live_bytes_of_a_known_sequence():
    with op_stats.OpCounter() as c:
        a = torch.empty(1000, device="meta")          # 4,000 live
        b = a + 1                                      # 8,000
        del a                                          # 4,000
        d = b * 2                                      # 8,000
        e = d[10:]                                     # a view: no bytes
        del b, d                                       # e keeps d: 4,000
        f = torch.zeros(2000, device="meta")           # 12,000: the peak
        del e                                          # 8,000
        g = f.sum()                                    # 8,004
        del f
        assert c.live_bytes == 4
    assert c.peak_bytes == 12000
    assert c.launches == 4              # add, mul, zeros, sum; not empty
    assert [b["bytes"] for b in c.top_buffers()] == [8000, 4000, 4000,
                                                     4000, 4]
    del g


def test_counter_splits_flops_by_dtype_and_skips_other_devices():
    with op_stats.OpCounter("meta") as c:
        x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
        w = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
        x @ w
        torch.ones(3) @ torch.ones(3, 5)               # host work: skipped
        x.float() @ w.float()
    assert dict(c.flops_by_dtype) == {"bfloat16": 2 * 4 * 8 * 16,
                                      "float32": 2 * 4 * 8 * 16}


def test_meta_account_equals_a_counted_cpu_step():
    """No step branches on its device: the account of a reduced train
    step on meta has the FLOPs of the same step counted as it runs on the
    CPU, and within 1% of its transient peak."""
    cfg = treg.REDUCED["qwen3-1.7b"]
    shape = ShapeConfig("t", 32, 2, "train")
    counts = dryrun.count_step(cfg, shape, dtype=torch.float32, remat=False)
    g = torch.Generator().manual_seed(0)
    model = TT.Transformer(cfg, TL.init_params(TT.model_spec(cfg),
                                               torch.float32, generator=g,
                                               device="cpu"), trainable=True)
    opt = TO.AdamWConfig()
    state = TO.init_opt_state(model.tree(), opt)
    tok = torch.randint(0, cfg.vocab_size, (2, 32), dtype=torch.int32)
    step = TSTEP.make_train_step(cfg, opt, remat=False)
    with op_stats.OpCounter("cpu") as c:
        step(model, state, {"tokens": tok, "labels": tok})
    assert dict(c.flops_by_dtype) == counts["flops_by_dtype"]
    assert abs(c.peak_bytes - counts["transient_peak"]) <= \
        0.01 * counts["transient_peak"]


# -- the ring model ----------------------------------------------------------

def test_wire_bytes_match_the_reference_ring_model():
    for op in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute"):
        for g in (1, 2, 3, 8, 16, 256, 512):
            for size in (0, 1, 4096, 123_456_789):
                assert analysis.wire_bytes(op, size, g) == \
                    hlo_stats._wire_bytes(op, size, g), (op, g, size)


def test_groups_span_nodes_by_mesh_position():
    single, multi = MESHES["single"], MESHES["multi"]
    assert NODE_SIZE == 8
    # 16 consecutive devices on the model axis span two nodes; a debug
    # mesh of 8 fits one
    assert analysis.group_spans_nodes(single, ("model",))
    assert analysis.group_spans_nodes(single, ("data",))
    assert analysis.group_spans_nodes(multi, ("pod",))
    assert not analysis.group_spans_nodes(MESHES["debug"], ("model",))
    assert not analysis.group_spans_nodes(MESHES["debug"], ("data",))
    assert not analysis.group_spans_nodes(single, ())
    small = TR.MeshShape(("data", "model"), (2, 4))
    assert not analysis.group_spans_nodes(small, ("data", "model"))
    assert analysis.group_spans_nodes(TR.MeshShape(("data", "model"),
                                                   (4, 4)), ("data",))


def test_param_collectives_of_fsdp_tp_and_ep_leaves():
    mesh = TR.MeshShape(("data", "model"), (2, 4))     # one node
    mib = 2 ** 20
    leaves = [(8 * mib, ("vocab", "embed"), ("model", "data")),  # TP+FSDP
              (8 * mib, ("embed", "ffn"), (None, "model")),      # TP only
              (8 * mib, ("experts", "embed"), (("data", "model"),)),  # EP
              (8 * mib, ("null",), ())]                          # replica
    coll = analysis.param_collectives(mesh, leaves, train=True, remat=True)
    s = coll.summary
    # the FSDP leaf: gathered over data (2) twice, its model shard kept
    assert s["all-gather"]["count"] == 2
    assert s["all-gather"]["wire_bytes"] == 2 * (1 / 2) * (8 * mib / 4)
    assert s["reduce-scatter"] == {"count": 1, "bytes": mib,
                                   "wire_bytes": 1 * mib}
    # the TP leaf and the replica: gradients all-reduced over data
    assert s["all-reduce"]["count"] == 2
    assert s["all-reduce"]["wire_bytes"] == 2 * (1 / 2) * (2 * mib + 8 * mib)
    assert coll.ib_bytes == 0 and coll.nvlink_bytes == sum(
        v["wire_bytes"] for v in s.values())
    serve = analysis.param_collectives(mesh, leaves, train=False,
                                       remat=False)
    assert list(serve.summary) == ["all-gather"]
    assert serve.summary["all-gather"]["count"] == 1


def test_roofline_floor_is_the_largest_term():
    coll = analysis.Collectives(MESHES["debug"])
    r = analysis.roofline({"bfloat16": 989e12, "float32": 67e12}, 3.35e12,
                          1e15, coll)
    assert r["compute_s"] == pytest.approx(2.0)
    assert r["memory_s"] == pytest.approx(1.0)
    assert r["bound"] == "compute" and r["step_floor_s"] == r["compute_s"]
    assert r["eager_memory_s"] == pytest.approx(1e15 / 3.35e12)
    assert analysis.model_flops(10, 3, "train") == 180
    assert analysis.model_flops(10, 3, "decode") == 60


# -- whole records ------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,multi", [
    ("qwen3-1.7b", "train_4k", False), ("qwen3-1.7b", "decode_32k", True)])
def test_run_cell_on_a_full_size_cell(arch, shape, multi, tmp_path):
    out = tmp_path / "cell.json"
    rec = dryrun.run_cell(arch, shape, multi, str(out))
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    mesh = make_production_mesh(multi_pod=multi)
    assert rec["devices"] == mesh.size == (512 if multi else 256)
    assert rec["split"] == "ideal" and rec["collectives_modelled"] == "params"
    for key in ("flops_per_device", "bytes_per_device", "collectives",
                "top_buffers", "params_total", "params_active",
                "tokens_per_step", "model_flops_total",
                "model_flops_per_device", "useful_flops_fraction",
                "launches", "flops_by_dtype", "eager_bytes", "global",
                "fits_80g"):
        assert key in rec, key
    r = rec["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "bound",
                "step_floor_s", "compute_fraction", "nvlink_bytes",
                "ib_bytes", "eager_bytes", "eager_memory_s", "min_bytes"):
        assert key in r, key
    assert r["step_floor_s"] == max(r["compute_s"], r["memory_s"],
                                    r["collective_s"]) > 0
    assert rec["flops_per_device"] * rec["devices"] == rec["global"]["flops"]
    assert (rec["params_total"], rec["params_active"]) == \
        _jax_count_params(jreg.ARCHS[arch])
    assert 0 < rec["useful_flops_fraction"] <= 1
    assert rec["fits_80g"] is True
    assert len(rec["top_buffers"]) == op_stats.TOP_BUFFERS
    cfg = treg.ARCHS[arch]
    # bf16 parameters, each leaf split as JAX's spec_for splits it
    jcfg = jreg.ARCHS[arch]
    want = 0.0
    for leaf in jax.tree.leaves(JT.model_spec(jcfg), is_leaf=JL.is_spec):
        p = JR.spec_for(leaf.axes, JR.param_rules(jcfg), mesh, leaf.shape)
        want += 2 * np.prod(leaf.shape) / TR.shard_count(spec(p), mesh)
    assert rec["memory"]["params_bytes"] == pytest.approx(want, rel=1e-12)
    if shape == "train_4k":
        assert rec["memory"]["opt_state_bytes"] == pytest.approx(
            4 * rec["memory"]["params_bytes"])
        assert rec["tokens_per_step"] == 256 * 4096
        assert r["bound"] == "compute"
        assert set(rec["flops_by_dtype"]) == {"bfloat16", "float32"}
    else:
        kv = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads \
            * cfg.head_dim * 2
        # batch over (pod, data) = 32, sequence over model = 16
        assert rec["memory"]["caches_bytes"] == kv / 512
        assert rec["tokens_per_step"] == 128


def test_int8_moments_step_on_meta():
    """The meta branch of ``draw_uniforms``: an int8-moment train step
    (deepseek-v3-671b's override) runs on the meta device; on the CPU the
    draws are unchanged."""
    with op_stats.OpCounter("meta") as c:
        drawn = TO.draw_uniforms(0, 1, 2, (3, 5), "meta")
    assert tuple(drawn.shape) == (3, 5) and drawn.dtype == torch.float32
    # counted as the card runs it: one launch writing 15 float32
    assert (c.launches, c.eager_bytes, c.peak_bytes) == (1, 60, 60)
    cpu = TO.draw_uniforms(0, 1, 2, (3, 5), "cpu")
    g = torch.Generator().manual_seed(TO._leaf_seed(0, 1, 2))
    assert torch.equal(cpu, torch.rand((3, 5), generator=g))
    cfg = treg.REDUCED["deepseek-v3-671b"]
    counts = dryrun.count_step(cfg, ShapeConfig("t", 32, 8, "train"))
    assert counts["microbatches"] == 8
    assert isinstance(counts["opt_state"]["m"]["embed"], list)
    assert sum(counts["flops_by_dtype"].values()) > 0


def test_main_writes_a_record_per_mesh(tmp_path):
    out = tmp_path / "d"
    assert dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                        "--mesh", "both", "--out-dir", str(out)]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["mamba2-780m_long_500k_multi.json",
                     "mamba2-780m_long_500k_single.json"]
    recs = [json.loads((out / n).read_text()) for n in names]
    assert recs[0]["global"] == recs[1]["global"]
    assert recs[0]["devices"] == 2 * recs[1]["devices"]
