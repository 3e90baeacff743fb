"""Faults planted under a cell's timed path, for the tests that see the
output check come out not correct (portbench/tests/test_pb_faults.py)
and for the fault readings on the card (portbench/control.py --faults).
Each is a context manager that patches humor_torch for its duration:

  unchanged     each step returns the state it was given (an L-BFGS run
                returns its start; the optimizer leaves the parameters);
  half_batch    half of the batch left out, the mean taken over the rest
                (each window's fit loss the mean of the first half's;
                the ELBO over the first half of the rows);
  altered       an answer altered where it is produced (the fit's stage-1
                result moved by 1 cm; each training step's reported loss
                off by 1%);
  rollout_vjp   (fits) the rollout's backward, the gradient stage 3 takes
                through the HuMoR rollout, returned at half its value.

A cell runs on one chip, so there is no exchange between chips to leave
out.
"""

from __future__ import annotations

import contextlib

import torch

FIT_FAULTS = ("unchanged", "half_batch", "altered", "rollout_vjp")
TRAIN_FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged_lbfgs(loss_fn, init_params, num_iters, **kw):
    from humor_torch.fitting.lbfgs import LbfgsResult

    with torch.no_grad():
        v = loss_fn({k: t[None] for k, t in init_params.items()})[0]
    return LbfgsResult({k: t.detach().clone() for k, t in
                        init_params.items()}, v, v.repeat(num_iters))


def _half_windows(fn, B: int):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        v = out.reshape(-1, B)
        return v[:, :B // 2].mean(dim=1, keepdim=True).expand_as(v) \
            .reshape(out.shape)
    return wrapped


@contextlib.contextmanager
def fit_fault(name: str, batch: int):
    from humor_torch.fitting import energies as E
    from humor_torch.fitting import optimizer as O
    from humor_torch.ops import rollout_kernel as RK

    with contextlib.ExitStack() as stack:
        if name == "unchanged":
            stack.enter_context(_patched(O, "run_lbfgs", _unchanged_lbfgs))
        elif name == "half_batch":
            for f in ("root_fit", "smpl_fit", "motion_fit"):
                stack.enter_context(_patched(
                    E, f, _half_windows(getattr(E, f), batch)))
        elif name == "altered":
            make = O.make_runner

            def make_runner(*a, **kw):
                run = make(*a, **kw)

                def altered(*ra, **rk):
                    res = run(*ra, **rk)
                    res.per_stage["stage1"]["trans"].add_(1e-2)
                    return res
                return altered

            stack.enter_context(_patched(O, "make_runner", make_runner))
        elif name == "rollout_vjp":
            vjp = RK.rollout_backward

            def halved(*a, **kw):
                return tuple(g * 0.5 for g in vjp(*a, **kw))

            stack.enter_context(_patched(RK, "rollout_backward", halved))
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield


@contextlib.contextmanager
def train_fault(name: str):
    from humor_torch.train import step as TS

    with contextlib.ExitStack() as stack:
        if name == "unchanged":
            stack.enter_context(_patched(
                TS._Optimizer, "update",
                lambda self, grads, state, params: state))
        elif name == "half_batch":
            elbo = TS.elbo_loss

            def half(cfg, pred, posterior, prior, gt, epoch,
                     gender_ids=None, betas=None, smpl_models=None):
                n = gt["trans"].shape[0] // 2
                cut = lambda d: {k: v[:n] for k, v in d.items()}
                return elbo(cfg, cut(pred), tuple(v[:n] for v in posterior),
                            tuple(v[:n] for v in prior), cut(gt), epoch,
                            gender_ids=gender_ids[:n], betas=betas[:n],
                            smpl_models=smpl_models)

            stack.enter_context(_patched(TS, "elbo_loss", half))
        elif name == "altered":
            make = TS.make_train_steps

            def make_train_steps(*a, **kw):
                steps = make(*a, **kw)

                def off(step):
                    def wrapped(*sa, **sk):
                        state, stats = step(*sa, **sk)
                        stats["total_loss"] = stats["total_loss"] * 1.01
                        return state, stats
                    return wrapped
                return (off(steps[0]), off(steps[1]), steps[2])

            stack.enter_context(_patched(TS, "make_train_steps",
                                         make_train_steps))
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield
