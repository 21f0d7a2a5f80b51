"""The reference side of `test_torch_serving_tp.py` that runs in worker
processes: one drain of the reference engine of `test_serving_tp.py`
(its TP engine over the 8 virtual CPU devices `conftest.py` sets up, or
its single-device engine). Each drain spends ~8 s lowering the
interpret-mode paged kernel, so the test runs them in parallel."""
import conftest  # noqa: F401  (the CPU platform with 8 virtual devices)
import test_serving_tp as REF
from paddle_tpu.serving import NgramProposer, tp_serving_mesh


def drain(work, tp, kw):
    """(outputs, host traces, metrics snapshot) of the reference engine
    at model degree tp (None: single-device) over `work`."""
    kw = dict(kw)
    if kw.get("proposer") == "ngram":
        kw["proposer"] = NgramProposer()
    out, traces, _, _, snap = REF._run_traced(
        REF._fresh_model(), tp_serving_mesh(tp) if tp else None, work, **kw)
    return out, traces, snap
