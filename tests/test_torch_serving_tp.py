"""Tensor-parallel serving of the port against the reference.

The port's ranks are four gloo processes on the CPU, started once for
the module by the port's `spawn` (`_torch_tp_ranks.run`: one tp 4 mesh
and two tp 2 meshes over the same world). While they run, this process
drains the reference engines of `test_serving_tp.py` — its TP engine
(GSPMD over 8 virtual CPU devices, the interpret-mode paged kernel) and
its single-device engine — on the reference test's configuration (vocab
128, hidden 256, 1 layer, 4 heads, 4 KV heads, fp32, pinned buckets) and
workloads, and evaluates the reference's mpu layers and
`paged_attention_decode_tp` on the inputs it sent the ranks.

Held: greedy tokens at tp 2 and tp 4 equal to the reference TP engine's
and its single-device engine's (plain with the prefix cache, int8 KV at
tp 4, wq int8 at tp 2, ngram speculation at tp 2); every rank of a group
emits the same tokens (sampled ones too); the group's first rank's host
trace equals the reference TP engine's at every step; the per-rank
capacity rule; the refusals; a mesh-less engine beside a live group
issues no collective; the metrics merge of mixed TP degrees; the mpu
layers and the paged decode within 1e-5; `shard_state_dict` against a
split model and the reference's sharding specs.

Construction-time checks (capacity, refusals, sharding) build engines
and split models in this process over a rank's `ModelParallelMesh`
without a group: nothing collective runs before the first step.
"""
import multiprocessing
import os
import pickle
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle

# the reference test module is imported here before pytest collects it:
# keep its asserts rewritten as pytest would
pytest.register_assert_rewrite("test_serving_tp")
import test_serving_tp as REF  # noqa: E402
from paddle_tpu.distributed.fleet import mpu as ref_mpu
from paddle_tpu.kernels.paged_attention import \
    paged_attention_decode_tp as ref_paged_tp
from paddle_tpu.models.llama import LlamaConfig as RefConfig
from paddle_tpu.models.llama import LlamaForCausalLM as RefLlama
from paddle_tpu.nn.quant import quantize_for_serving as ref_quantize
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import ServingMetrics as RefMetrics
from paddle_tpu.serving import tp_serving_mesh as ref_mesh

import _torch_tp_ranks
import _torch_tp_reference
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.fleet.mpu import ModelParallelMesh
from paddle_tpu_torch.models.convert import (from_jax_state_dict,
                                             shard_state_dict)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.quant import quantize_for_serving
from paddle_tpu_torch.serving import (ServingEngine, ServingMetrics,
                                      UnsupportedFeature, tp_serving_mesh)

CPU = torch.device("cpu")
# scenario -> (workload, tp, engine kwargs)
SCENARIOS = {
    "plain_tp2": ("plain", 2, {}),
    "plain_tp4": ("plain", 4, {}),
    "int8_tp4": ("int8", 4, {"kv_dtype": "int8"}),
    "wq_tp2": ("wq", 2, {"wq": "int8"}),
    "spec_tp2": ("spec", 2, {"proposer": "ngram", "spec_k": 2,
                             "spec_buckets": [2]}),
}
# which ranks ran each scenario (the tp 2 groups are {0, 1} and {2, 3})
RANKS = {"plain_tp2": (0, 1), "spec_tp2": (0, 1), "sampled_tp2": (0, 1),
         "wq_tp2": (2, 3), "multi_tp2": (2, 3), "plain_tp4": (0, 1, 2, 3),
         "int8_tp4": (0, 1, 2, 3)}


def _workloads():
    rng = np.random.RandomState(3)
    cyc = rng.randint(0, 128, (5,)).tolist()
    return {"plain": REF._mixed_workload(16),
            "int8": REF._mixed_workload(4, seed=9),
            "wq": REF._mixed_workload(4, seed=11),
            "spec": [((cyc * 6)[:24], 6) for _ in range(4)]}


def _paged_inputs(rng, int8: bool):
    """B 3 rows over a 16-page pool (page 8, D 64), H 8 over KVH 4, so
    tp 2 and tp 4 both split it; tables of 4 pages, lengths 5, 17, 32."""
    B, H, KVH, D, page, pages, P = 3, 8, 4, 64, 8, 16, 4
    q = rng.randn(B, H, D).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, pages))[:P]
                   for _ in range(B)]).astype(np.int32)
    sl = np.array([5, 17, 32], np.int32)
    if not int8:
        k, v = (rng.randn(pages, KVH, page, D).astype(np.float32)
                for _ in range(2))
        return {"q": q, "k": k, "v": v, "bt": bt, "sl": sl}
    k, v = (rng.randint(-127, 128, (pages, KVH, page, D)).astype(np.int8)
            for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (pages, KVH, page))
              .astype(np.float32) for _ in range(2))
    return {"q": q, "k": k, "v": v, "bt": bt, "sl": sl, "k_scale": ks,
            "v_scale": vs}


def _layer_inputs():
    rng = np.random.RandomState(5)
    return {"layer_x": rng.randn(2, 3, 32).astype(np.float32),
            "layer_ids": rng.randint(0, 24, (2, 3)).astype(np.int64),
            "row_x": rng.randn(2, 3, 40).astype(np.float32),
            "w_col": rng.randn(32, 40).astype(np.float32) / 6.0,
            "w_row": rng.randn(40, 24).astype(np.float32) / 6.0,
            "w_emb": rng.randn(24, 32).astype(np.float32),
            "paged_full": _paged_inputs(rng, False),
            "paged_int8": _paged_inputs(rng, True)}


def _ref_weights(model):
    return {k: np.asarray(v._data) for k, v in model.state_dict().items()}


def _ref_layers(inp, tp):
    """The reference's mpu layers and paged decode under a GSPMD mesh of
    model degree tp, on the inputs the ranks got."""
    mesh = ref_mesh(tp)
    out = {}
    with ref_mpu.mesh_scope(mesh):
        x = paddle.to_tensor(inp["layer_x"])
        for gather in (True, False):
            col = ref_mpu.ColumnParallelLinear(32, 40, has_bias=False,
                                               gather_output=gather)
            col.weight.set_value(inp["w_col"])
            out[f"col_gather_{gather}"] = np.asarray(col(x)._data)
        for parallel in (False, True):
            row = ref_mpu.RowParallelLinear(40, 24, has_bias=False,
                                            input_is_parallel=parallel)
            row.weight.set_value(inp["w_row"])
            out[f"row_parallel_{parallel}"] = np.asarray(
                row(paddle.to_tensor(inp["row_x"]))._data)
        emb = ref_mpu.VocabParallelEmbedding(24, 32)
        emb.weight.set_value(inp["w_emb"])
        out["embedding"] = np.asarray(
            emb(paddle.to_tensor(inp["layer_ids"]))._data)
    out["tied_head"] = inp["layer_x"] @ inp["w_emb"].T
    for kv in ("full", "int8"):
        p = {k: jnp.asarray(v) for k, v in inp[f"paged_{kv}"].items()}
        scales = ({"k_scale": p["k_scale"], "v_scale": p["v_scale"]}
                  if kv == "int8" else {})
        fn = jax.jit(lambda q, k, v, bt, sl, **s: ref_paged_tp(
            q, k, v, bt, sl, mesh, manual=False, **s))
        out[f"paged_{kv}"] = np.asarray(fn(p["q"], p["k"], p["v"], p["bt"],
                                           p["sl"], **scales))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the four port ranks, run the reference meanwhile (its nine
    engine drains in three worker processes), then collect both."""
    tmp = tmp_path_factory.mktemp("tp_ranks")
    work = _workloads()
    inputs = _layer_inputs()
    job = {"cfg": REF.CFG, "engine_kw": REF.ENGINE_KW, "work": work,
           "weights": _ref_weights(REF._fresh_model()), **inputs}
    job_path = os.path.join(tmp, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    ranks = spawn(_torch_tp_ranks.run, args=(job_path, str(tmp)), nprocs=4,
                  join=False)
    base = {"plain": {}, "int8": {"kv_dtype": "int8"}, "wq": {"wq": "int8"},
            "spec": SCENARIOS["spec_tp2"][2]}
    try:
        with ProcessPoolExecutor(
                3, mp_context=multiprocessing.get_context("spawn")) as pool:
            tp_runs = {sc: pool.submit(_torch_tp_reference.drain, work[wl],
                                       tp, kw)
                       for sc, (wl, tp, kw) in SCENARIOS.items()}
            base_runs = {wl: pool.submit(_torch_tp_reference.drain,
                                         work[wl], None, kw)
                         for wl, kw in base.items()}
            ref = {"layers": {tp: _ref_layers(inputs, tp) for tp in (2, 4)},
                   "tp": {k: f.result() for k, f in tp_runs.items()},
                   "base": {k: f.result() for k, f in base_runs.items()}}
        ranks.join(timeout=300)
    finally:
        ranks.kill()
    res = []
    for r in range(4):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return ref, res


def test_ranks_are_gloo_processes_on_the_cpu(world):
    _, res = world
    assert [r["backend"] for r in res] == ["gloo"] * 4
    assert [r["device"] for r in res] == ["cpu"] * 4
    assert [r["rank2"] for r in res] == [0, 1, 0, 1]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_tp_tokens_equal_the_reference(world, scenario):
    """Greedy tokens of every rank of the group == the reference TP
    engine's == the reference single-device engine's."""
    ref, res = world
    wl, tp, _ = SCENARIOS[scenario]
    outs = [res[r][scenario][0] for r in RANKS[scenario]]
    assert all(o == outs[0] for o in outs), "ranks disagree"
    ref_tp_out, _, ref_snap = ref["tp"][scenario]
    assert outs[0] == ref_tp_out
    assert outs[0] == ref["base"][wl][0]
    snap = res[RANKS[scenario][0]][scenario][2]
    assert snap["kv_tp_degree"] == tp == ref_snap["kv_tp_degree"]
    for key in ("kv_page_bytes", "kv_page_bytes_shard", "kv_pool_bytes",
                "kv_pool_bytes_shard", "prefix_hits", "decode_tokens"):
        assert snap[key] == ref_snap[key], key
    assert snap["kv_page_bytes_shard"] * tp == snap["kv_page_bytes"]
    if wl == "plain":
        assert snap["prefix_hits"] > 0
    if wl == "spec":
        assert snap["spec_accepted_tokens"] == \
            ref_snap["spec_accepted_tokens"] > 0


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_host_traces_equal_the_reference_tp_engine(world, scenario):
    """The group's first rank's per-step host trace (free list, refs,
    radix, request states, pages, outputs) == the reference TP
    engine's, step for step."""
    ref, res = world
    traces = res[RANKS[scenario][0]][scenario][1]
    assert traces == ref["tp"][scenario][1]


def test_multi_step_decode_under_tp_equals_the_reference(world):
    """decode_steps=4 at tp 2 (K decode steps a launch, each step's
    collectives inside it): both ranks emit the reference TP engine's
    plain greedy tokens, which K steps a launch must not change."""
    ref, res = world
    a, b = (res[r]["multi_tp2"][0] for r in RANKS["multi_tp2"])
    assert a == b == ref["tp"]["plain_tp2"][0]


def test_sampled_ranks_agree(world):
    _, res = world
    a, b = (res[r]["sampled_tp2"][0] for r in RANKS["sampled_tp2"])
    assert a == b
    assert a != res[0]["plain_tp2"][0]
    assert all(0 <= t < REF.CFG["vocab_size"] for o in a for t in o)


def test_meshless_engine_beside_a_live_group_issues_no_collective(world):
    ref, res = world
    for r in (2, 3):
        assert res[r]["meshless_collectives"] == 0
        assert res[r]["meshless"][0] == ref["base"]["plain"][0]
        assert res[r]["meshless"][2]["kv_tp_degree"] == 1


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["col_gather_True", "col_gather_False",
                                  "row_parallel_False", "row_parallel_True",
                                  "embedding", "tied_head", "paged_full",
                                  "paged_int8"])
def test_mpu_layers_and_paged_decode_tp(world, name, tp):
    """Each rank's output (its shard where the layer leaves it split,
    concatenated over the ranks) == the reference's GSPMD output within
    1e-5."""
    ref, res = world
    ranks = (0, 1) if tp == 2 else (0, 1, 2, 3)
    got = [res[r][f"layers_tp{tp}"][name] for r in ranks]
    if name == "col_gather_False":
        got = np.concatenate(got, axis=-1)
    elif name.startswith("paged"):
        got = np.concatenate(got, axis=1)
    else:
        assert all(np.array_equal(g, got[0]) for g in got)
        got = got[0]
    np.testing.assert_allclose(got, ref["layers"][tp][name], rtol=1e-5,
                               atol=1e-5)


def _port_model(cfg_kw=None, seed=0):
    paddle.seed(seed)
    ref = RefLlama(RefConfig(**(cfg_kw or REF.CFG)))
    cfg = LlamaConfig(**(cfg_kw or REF.CFG))
    port = LlamaForCausalLM(cfg, device="cpu")
    port.load_state_dict(from_jax_state_dict(_ref_weights(ref), cfg))
    return ref, port, cfg


def _rank_mesh(tp, rank=0):
    return ModelParallelMesh(tp, rank, None, None, CPU)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_capacity_is_a_per_rank_budget(kv_dtype):
    """pages = per-rank kv_pool_bytes // kv_page_bytes_shard, the same
    numbers as the reference TP engine's."""
    kw = dict(REF.ENGINE_KW)
    kw.pop("num_pages")
    pool = 1 << 20
    _, model, _ = _port_model()
    ref_model = REF._fresh_model()
    for tp in (1, 2, 4):
        _, port, _ = _port_model()
        eng = ServingEngine(port, mesh=_rank_mesh(tp) if tp > 1 else None,
                            device="cpu", kv_pool_bytes=pool,
                            kv_dtype=kv_dtype, **kw)
        r = RefEngine(ref_model, mesh=ref_mesh(tp) if tp > 1 else None,
                      kv_pool_bytes=pool, kv_dtype=kv_dtype, **kw)
        assert eng.num_pages == r.num_pages == \
            pool // eng.kv_page_bytes_shard
        assert eng.kv_page_bytes_shard == r.kv_page_bytes_shard
        assert eng.kv_page_bytes == r.kv_page_bytes
        assert eng.kv_caches[0][0].shape[1] == REF.CFG[
            "num_key_value_heads"] // tp
        assert eng.metrics.snapshot()["kv_pool_bytes_shard"] == \
            eng.num_pages * eng.kv_page_bytes_shard <= pool
        r.shutdown()


def test_refusals_match_the_reference():
    """Heads the model degree does not divide: ValueError with the
    reference's message; lora or host_spill with a mesh: the
    reference's class and reason; compile_cache is still unported."""
    cfg_kw = dict(vocab_size=64, hidden_size=192, intermediate_size=64,
                  num_hidden_layers=1, num_attention_heads=3,
                  num_key_value_heads=3, max_position_embeddings=64)
    ref, port, _ = _port_model(cfg_kw)
    kw = dict(num_pages=16, page_size=8, temperature=0.0)
    with pytest.raises(ValueError) as want:
        RefEngine(ref, mesh=ref_mesh(2), **kw)
    with pytest.raises(ValueError) as got:
        ServingEngine(port, mesh=_rank_mesh(2), device="cpu", **kw)
    assert str(got.value) == str(want.value)
    assert "not divisible" in str(got.value)
    _, port, _ = _port_model()
    ref = REF._fresh_model()
    for extra in ({"lora": object()}, {"host_spill_pages": 8}):
        with pytest.raises(UnsupportedFeature) as got:
            ServingEngine(port, mesh=_rank_mesh(2), device="cpu",
                          **REF.ENGINE_KW, **extra)
        with pytest.raises(Exception) as want:
            RefEngine(ref, mesh=ref_mesh(2), **REF.ENGINE_KW, **extra)
        assert type(want.value).__name__ == "UnsupportedFeature"
        assert str(got.value) == str(want.value)
    with pytest.raises(UnsupportedFeature, match="compile_cache"):
        ServingEngine(port, mesh=_rank_mesh(2), device="cpu",
                      compile_cache=object(), **REF.ENGINE_KW)
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        tp_serving_mesh(2)


def test_metrics_merge_of_mixed_tp_degrees():
    """The reference test's two replicas (tp 1 and tp 2) and a
    homogeneous tp 2 pair: merged snapshots equal the reference's."""
    def pair(cls):
        a = cls(name="tp1")
        a.set_kv_info(kv_dtype="float32", page_bytes=1024,
                      pool_bytes=64 * 1024, bytes_per_token=128,
                      tp_degree=1, page_bytes_shard=1024,
                      pool_bytes_shard=64 * 1024)
        a.update_gauges(queue_depth=0, running=0, kv_used_pages=16,
                        kv_occupancy=0.25, cached_pages=0, radix_nodes=0)
        b, c = cls(name="tp2"), cls(name="tp2b")
        for m in (b, c):
            m.set_kv_info(kv_dtype="float32", page_bytes=1024,
                          pool_bytes=128 * 1024, bytes_per_token=128,
                          tp_degree=2, page_bytes_shard=512,
                          pool_bytes_shard=64 * 1024)
            m.update_gauges(queue_depth=0, running=0, kv_used_pages=64,
                            kv_occupancy=0.5, cached_pages=0,
                            radix_nodes=0)
        return cls.merge(a, b), cls.merge(b, c)

    keys = ("kv_pool_bytes", "kv_occupancy", "kv_page_bytes",
            "kv_tp_degree", "kv_page_bytes_shard", "kv_pool_bytes_shard",
            "kv_dtype", "kv_bytes_per_token")
    for got, want in zip(pair(ServingMetrics), pair(RefMetrics)):
        gs, ws = got.snapshot(), want.snapshot()
        assert {k: gs[k] for k in keys} == {k: ws[k] for k in keys}
    mixed = pair(ServingMetrics)[0]
    assert mixed.kv_tp_degree == 0 and mixed.kv_page_bytes_shard == 0
    assert mixed.kv_pool_bytes == (64 + 128) * 1024


@pytest.mark.parametrize("wq", [None, "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_state_dict_is_the_split_model(tp, wq):
    """For every rank: `shard_state_dict` of the whole converted state
    (the reference's, quantized by the reference for wq) == the state of
    a port model quantized whole and then split by `shard_`, bitwise;
    and each tensor is cut on the axis of the reference's sharding
    spec."""
    ref, _, cfg = _port_model()
    if wq:
        ref_quantize(ref, algo=f"weight_only_{wq}")
    whole = from_jax_state_dict(_ref_weights(ref), cfg, wq=wq)
    specs = {k: getattr(v, "_spec", None)
             for k, v in ref.state_dict().items()}
    for rank in range(tp):
        _, port, _ = _port_model()
        if wq:
            quantize_for_serving(port, algo=f"weight_only_{wq}")
        port.shard_(_rank_mesh(tp, rank))
        got = shard_state_dict(whole, cfg, rank, tp)
        sd = port.state_dict()
        assert set(got) == set(sd)
        for name, t in got.items():
            assert t.dtype == sd[name].dtype and torch.equal(t, sd[name]), \
                name
            cut = {i for i, (a, b) in enumerate(zip(whole[name].shape,
                                                    t.shape)) if a != b}
            spec = specs[name]
            want = ({i for i, ax in enumerate(spec) if ax == "model"}
                    if spec is not None else set())
            assert cut == want, (name, spec)
        with pytest.raises(ValueError, match="shard"):
            quantize_for_serving(port)
