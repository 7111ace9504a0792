"""Faults planted under the timed path, to show that `correct` comes out
false: each replaces one function of the program while it is active.

    train: state_unchanged (a step that leaves the state as it found it),
           half_batch (half of each batch left out, the mean taken over
           the rest)
    eval:  half_batch (the second half of the queries never ranked: the
           first half's ranks in their place), answer_altered (one query's
           rank moved where it is produced)
    serve: half_batch (the second half of a request's queries never
           embedded: the first half's in their place), answer_altered
           (each request's first answer replaced where it is produced)

The exchange between chips is absent: every cell runs on one chip.
"""

from __future__ import annotations

from contextlib import contextmanager

BATCH_WIDE = ("uniq", "sel", "sel_local")


def _train(fault: str):
    from dssm_tpu_torch.train import loop

    if fault == "state_unchanged":
        make = loop.make_train_step

        def make_train_step(cfg, impl="auto"):
            real = make(cfg, impl)

            def step(state, batch):
                keep = {t: {k: v.clone() for k, v in tp.items()}
                        for t, tp in state.params.items()}
                state, aux = real(state, batch)
                for t, tp in keep.items():
                    for k, v in tp.items():
                        state.params[t][k].copy_(v)
                return state, aux
            return step

        return loop, "make_train_step", make_train_step
    if fault == "half_batch":
        make_body = loop.make_train_step_body

        def make_train_step_body(cfg, impl="auto"):
            body = make_body(cfg, impl)

            def half(state, batch):
                b = batch["q_wgt"].shape[0] // 2
                return body(state, {k: v if k in BATCH_WIDE else v[:b]
                                    for k, v in batch.items()})
            return half

        return loop, "make_train_step_body", make_train_step_body
    raise ValueError(fault)


def _eval(fault: str):
    from dssm_tpu_torch.train import eval as eval_mod

    ranks_of = eval_mod.compute_ranks

    def compute_ranks(q, d, **kw):
        r = ranks_of(q, d, **kw).copy()
        if fault == "half_batch":
            h = r.shape[0] // 2
            r[h:2 * h] = r[:h]
        elif fault == "answer_altered":
            n = d.shape[0]
            r[0] = r[0] + n // 4 if r[0] <= n // 2 else 1
        else:
            raise ValueError(fault)
        return r

    return eval_mod, "compute_ranks", compute_ranks


def _serve(fault: str):
    from dssm_tpu_torch.serve import retrieval

    if fault == "half_batch":
        embed = retrieval.embed_queries

        def embed_queries(params, cfg, queries, *a, **kw):
            h = len(queries) // 2
            return embed(params, cfg, list(queries[:h]) * 2, *a, **kw)

        return retrieval, "embed_queries", embed_queries
    if fault == "answer_altered":
        top_k = retrieval.top_k

        def altered(q, d, *a, **kw):
            s, i = top_k(q, d, *a, **kw)
            i = i.copy()
            i[0, 0] = (i[0, 0] + d.shape[0] // 2) % d.shape[0]
            return s, i

        return retrieval, "top_k", altered
    raise ValueError(fault)


FAULTS = {"train": ("state_unchanged", "half_batch"),
          "eval": ("half_batch", "answer_altered"),
          "serve": ("half_batch", "answer_altered")}
_PLANT = {"train": _train, "eval": _eval, "serve": _serve}


@contextmanager
def planted(kind: str, fault: str):
    """The program with `fault` planted in its `kind` path, while active."""
    module, name, fn = _PLANT[kind](fault)
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)
