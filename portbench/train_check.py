"""The output check of the training cells: the plain reference
(portbench/reference: a frozen copy of the port's step, ELBO, gendered
SMPL and HuMoR modules, in float32 without TF32) follows the first chunk
of k steps that the program's window call makes, from the same seeded
weights, on the batches it gathers again from the same sequences and
step seeds, with the same draws:

  loss_gap     each step's loss, the largest relative gap;
  grad_gap     the gradients as the optimizer holds them after the chunk
               (Adamax's first moment, their b1-weighted sum: the k-step
               call leaves no state after its first step, and the moment
               weights the first step's gradient by b1^(k-1)), by the
               worst leaf: the gap between the program's norm of the
               leaf and the reference's, over the larger of the
               reference's norm of that leaf and of the median leaf;
  change_gap   the parameters' change over the chunk, by the worst leaf
               as above, over the leaves whose reference moment is at
               least a thousandth of the median leaf's (a leaf below,
               such as a bias that a softmax or a norm cancels, moves
               under Adamax by round-off alone).
"""

from __future__ import annotations

from typing import Dict, List

import torch


def leaf_gap(prog: List[torch.Tensor], ref: List[torch.Tensor],
             keep=None) -> float:
    pn = torch.stack([p.double().norm() for p in prog])
    rn = torch.stack([r.double().norm() for r in ref])
    if keep is not None:
        pn, rn = pn[keep], rn[keep]
    den = torch.maximum(rn, rn.median())
    return float(((pn - rn).abs() / den.clamp_min(1e-30)).max())


def reference_steps(tc, draws: Dict, seeds: List[int]):
    """The reference's losses, first moment and params after the steps
    of `seeds`, each with its slice of the stacked `draws`."""
    from portbench.reference import step as RS
    from portbench.reference.elbo import LossConfig
    from portbench.train_cell import loss_kwargs, optimizer
    from portbench.train_traffic import ReferenceStore

    store = ReferenceStore(tc.seqs)
    opt = optimizer(RS, tc.conf)
    sup, ss = RS.make_train_steps(tc.rhcfg, LossConfig(**loss_kwargs(
        tc.conf)), opt, tc.ref_bodies)
    state = RS.make_train_state(tc.weights, opt)
    losses = []
    for i, seed in enumerate(seeds):
        batch = store.batch(seed, tc.B, tc.T + 1, tc.device)
        d = {k: v[i] for k, v in draws.items()}
        if tc.sched:
            state, stats = ss(state, batch, tc.epoch, tc.use_gt_p, **d)
        else:
            state, stats = sup(state, batch, tc.epoch, **d)
        losses.append(float(stats["total_loss"]))
    moment = [m.detach() for m in RS.tree_leaves(state.opt_state["mu"])]
    params = [p.detach() for p in RS.tree_leaves(state.params)]
    return losses, moment, params


def gaps(tc, first: Dict) -> Dict[str, float]:
    from portbench.reference.step import tree_leaves

    losses, moment, params = reference_steps(tc, first["draws"],
                                             first["seeds"])
    p0 = [p.detach() for p in tree_leaves(tc.weights)]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(first["losses"],
                                                        losses))
    mn = torch.stack([m.double().norm() for m in moment])
    keep = mn >= 1e-3 * mn.median()
    change_p = [a - b for a, b in zip(first["params"], p0)]
    change_r = [a - b for a, b in zip(params, p0)]
    return {"loss_gap": loss_gap,
            "grad_gap": leaf_gap(first["moment"], moment),
            "change_gap": leaf_gap(change_p, change_r, keep)}


def compare(tc, first: Dict, limits: Dict) -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = gaps(tc, first)
    return {k: {"value": v, "limit": limits[k]} for k, v in g.items()}
