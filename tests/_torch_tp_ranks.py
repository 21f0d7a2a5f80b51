"""The rank side of `test_torch_serving_tp.py`: a world of four gloo
ranks on the CPU, started by the port's `spawn`. Imports the port, torch
and numpy only (never JAX or the reference): the test's main process
runs the reference and writes what the ranks need (weights, workloads,
inputs) into one pickle, and each rank writes its results into another.

Groups: the whole world is one tp 4 mesh; `tp_serving_mesh(2)` splits it
into {0, 1} ("a") and {2, 3} ("b"), which run different scenarios at the
same time. Every scenario drains a fresh engine of the reference test's
configuration and records its tokens, its snapshot and, on the group's
first rank, the host trace of every step."""
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.distributed.fleet.mpu import (ColumnParallelLinear,
                                                    RowParallelLinear,
                                                    VocabParallelEmbedding)
from paddle_tpu_torch.kernels.paged_attention import \
    paged_attention_decode_tp
from paddle_tpu_torch.models.convert import from_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.layer.common import Embedding, Linear
from paddle_tpu_torch.serving import (NgramProposer, ServingEngine,
                                      tp_serving_mesh)


def host_trace(eng, rid0):
    """One step's host bookkeeping: free-list order, refcounts, radix
    occupancy, per-request state, pages and outputs (ids relative to the
    run's first), as the reference test fingerprints it."""
    alloc = eng.allocator
    return (
        tuple(alloc._free),
        tuple(sorted(alloc._refs.items())),
        eng.radix.num_cached_pages if eng.radix else -1,
        eng.radix.num_nodes if eng.radix else -1,
        tuple(sorted(
            (rid - rid0, r.state.name,
             tuple(r.seq.pages) if getattr(r, "seq", None) is not None
             else (), tuple(r.output_ids))
            for rid, r in eng.requests.items())),
    )


def model_from(job):
    cfg = LlamaConfig(**job["cfg"])
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(from_jax_state_dict(job["weights"], cfg),
                          strict=True)
    return model


def drain(job, mesh, work, traced, **kw):
    """Drain `work` through a fresh engine; (outputs, traces or None,
    snapshot)."""
    eng = ServingEngine(model_from(job), mesh=mesh, device="cpu",
                        **{**job["engine_kw"], **kw})
    rids = [eng.add_request(p, max_new_tokens=m) for p, m in work]
    traces = [host_trace(eng, rids[0])] if traced else None
    while eng.has_work():
        eng.step()
        if traced:
            traces.append(host_trace(eng, rids[0]))
    out = [list(eng.requests[r].output_ids) for r in rids]
    snap = eng.metrics.snapshot()
    eng.reset_prefix_cache()
    assert eng.allocator.num_used == 0
    eng.allocator.check_invariants()
    return out, traces, snap


def layers(job, mesh):
    """This rank's outputs of each mpu layer and of the paged decode on
    the test's inputs (weights and inputs whole; each layer keeps its
    shard)."""
    x, ids = (torch.from_numpy(job["layer_x"]),
              torch.from_numpy(job["layer_ids"]))
    w_col, w_row, emb = (torch.from_numpy(job[k]) for k in
                         ("w_col", "w_row", "w_emb"))

    def linear(w):
        full = Linear(w.shape[0], w.shape[1], device="cpu")
        full.weight.data.copy_(w)
        return full

    res = {}
    with torch.no_grad():
        for gather in (True, False):
            col = ColumnParallelLinear(w_col.shape[0], w_col.shape[1],
                                       has_bias=False, gather_output=gather,
                                       mesh=mesh, full=linear(w_col))
            res[f"col_gather_{gather}"] = col(x).numpy()
        for parallel in (False, True):
            row = RowParallelLinear(w_row.shape[0], w_row.shape[1],
                                    has_bias=False,
                                    input_is_parallel=parallel, mesh=mesh,
                                    full=linear(w_row))
            a, b = row.shard
            xin = torch.from_numpy(job["row_x"])
            res[f"row_parallel_{parallel}"] = row(
                xin[..., a:b] if parallel else xin).numpy()
        full = Embedding(emb.shape[0], emb.shape[1], device="cpu")
        full.weight.data.copy_(emb)
        vemb = VocabParallelEmbedding(emb.shape[0], emb.shape[1], mesh=mesh,
                                      full=full)
        res["embedding"] = vemb(ids).numpy()
        res["tied_head"] = vemb.attend(x[..., :emb.shape[1]]).numpy()
        for kv in ("full", "int8"):
            p = job[f"paged_{kv}"]
            H, KVH = p["q"].shape[1], p["k"].shape[1]
            hq = slice(mesh.rank * H // mesh.tp,
                       (mesh.rank + 1) * H // mesh.tp)
            hk = slice(mesh.rank * KVH // mesh.tp,
                       (mesh.rank + 1) * KVH // mesh.tp)
            t = {k: torch.from_numpy(v) for k, v in p.items()}
            scales = ({"k_scale": t["k_scale"][:, hk].contiguous(),
                       "v_scale": t["v_scale"][:, hk].contiguous()}
                      if kv == "int8" else {})
            res[f"paged_{kv}"] = paged_attention_decode_tp(
                t["q"][:, hq].contiguous(), t["k"][:, hk].contiguous(),
                t["v"][:, hk].contiguous(), t["bt"], t["sl"], mesh,
                **scales).numpy()
    return res


def run(job_path, out_dir):
    torch.set_num_threads(1)
    env = init_parallel_env(device="cpu", timeout_s=120)
    rank = env.rank
    mesh4 = tp_serving_mesh(4)
    mesh2 = tp_serving_mesh(2)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    w = job["work"]
    res = {"backend": env.backend, "device": str(env.device),
           "rank2": mesh2.rank}
    first2 = mesh2.rank == 0
    res["plain_tp4"] = drain(job, mesh4, w["plain"], rank == 0)
    res["int8_tp4"] = drain(job, mesh4, w["int8"], rank == 0,
                            kv_dtype="int8")
    if rank < 2:                      # group a
        res["plain_tp2"] = drain(job, mesh2, w["plain"], first2)
        res["spec_tp2"] = drain(job, mesh2, w["spec"], first2,
                                proposer=NgramProposer(), spec_k=2,
                                spec_buckets=[2])
        res["sampled_tp2"] = drain(job, mesh2, w["plain"], False,
                                   temperature=0.8, top_k=20, seed=7)
        res["layers_tp2"] = layers(job, mesh2)
    else:                             # group b
        res["wq_tp2"] = drain(job, mesh2, w["wq"], first2, wq="int8")
        res["multi_tp2"] = drain(job, mesh2, w["plain"], False,
                                 decode_steps=4)
        # a mesh-less engine beside a live group issues no collective
        calls = []
        real = dist.all_reduce

        def counting(*a, **k):
            calls.append(1)
            return real(*a, **k)

        dist.all_reduce = counting
        try:
            res["meshless"] = drain(job, None, w["plain"], False)
        finally:
            dist.all_reduce = real
        res["meshless_collectives"] = len(calls)
    res["layers_tp4"] = layers(job, mesh4)
    dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


# ------------------------------------------------------------ on the card
# (tests/test_torch_cuda.py; each rank on the card init_parallel_env
# picks: NCCL with a card per rank, else gloo on cuda:0)

def card_all_reduce(out_dir):
    """Sum a CUDA tensor of each dtype over the world; write what came
    back and the backend."""
    env = init_parallel_env(timeout_s=120)
    res = {"backend": env.backend, "device": str(env.device)}
    for dt in (torch.float32, torch.bfloat16):
        t = torch.arange(8, device=env.device, dtype=dt) + env.rank
        dist.all_reduce(t)
        res[str(dt)] = (t.device.type, t.float().cpu().tolist())
    with open(os.path.join(out_dir, f"rank{env.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


CARD_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256)
CARD_KW = dict(page_size=16, num_pages=64, token_budget=64,
               batch_buckets=[4], prefill_buckets=[64], pages_buckets=[8],
               temperature=0.0)


def card_engine(out_dir, kw):
    """A small fp32 model (seeded on the card) served at tp 1 with no
    mesh and at the world's degree: each rank's tokens and paged
    launches."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    env = init_parallel_env(timeout_s=120)
    mesh = tp_serving_mesh(env.world_size)
    rng = np.random.RandomState(0)
    work = [(rng.randint(0, 512, int(n)).tolist(), 8)
            for n in rng.randint(3, 60, size=6)]
    res = {"backend": env.backend}
    for tp in (1, env.world_size):
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        model = LlamaForCausalLM(LlamaConfig(**CARD_CFG), device=mesh.device,
                                 generator=gen)
        eng = ServingEngine(model, mesh=mesh if tp > 1 else None,
                            device=mesh.device, **{**CARD_KW, **kw})
        rids = [eng.add_request(p, max_new_tokens=m) for p, m in work]
        before = (pa.paged_attention_decode.launches
                  + pa.paged_attention_decode.int8_launches)
        out = eng.run()
        res[tp] = ([out[r] for r in rids],
                   pa.paged_attention_decode.launches
                   + pa.paged_attention_decode.int8_launches - before,
                   eng.metrics.counters["decode_launches"])
    with open(os.path.join(out_dir, f"rank{env.rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
