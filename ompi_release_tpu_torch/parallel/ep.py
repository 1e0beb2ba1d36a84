"""Expert parallelism: the switch-MoE layer of
``ompi_release_tpu/parallel/ep.py:20-97`` over the ep axis.

Top-1 (switch) routing with a fixed per-expert capacity, so the dispatch
and combine tensors have static shapes; tokens over capacity are
dropped and their outputs are zero (the residual carries them). Inside a
mesh (``parallel/mesh_axes.py``'s stacked layout) the capacity comes
from each rank's own token count, the ``(n, E_local, C, D)`` queues
cross the ep ranks by two untiled ``all_to_all`` calls (a transpose of
the ep rank dim with the queue's leading dim) and the aux loss is
``pmean``'d over ep; the experts of every rank run as one batched
product. Outside a mesh the layer is the one-rank math with one product
per expert. ``dropless_moe`` (``:100-189``) is the exact-count
alternative over ``alltoallv``; on a communicator spanning processes
each process acts as its local ranks (``comm.local_comm_ranks``).

The dispatch and combine einsums are f32 products over one-hot tensors:
each expert slot holds at most one token and each token sits in at most
one slot, so both are exact in any summation order (with TF32 off).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import axes


def _one_hot_dispatch(logits: torch.Tensor, n_experts: int, capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine) for top-1 routing. logits: (..., T, E);
    dispatch: (..., T, E, C) f32 one-hot slot assignment; combine:
    dispatch times the gate probability. Only ``combine`` carries a
    gradient (through the gate); the argmax and the one-hots carry
    none."""
    probs = torch.softmax(logits.float(), dim=-1)
    expert = probs.argmax(dim=-1)  # the first maximum, as jnp.argmax
    gate = probs.gather(-1, expert[..., None])[..., 0]
    eh = F.one_hot(expert, n_experts).to(torch.int32)  # (..., T, E)
    # position of each token within its expert's queue
    pos = torch.cumsum(eh, dim=-2, dtype=torch.int32) * eh - eh
    keep = (pos < capacity) & (eh == 1)
    slot = torch.where(keep, pos, torch.zeros_like(pos))
    dispatch = F.one_hot(slot.long(), capacity).float() * keep[..., None]
    combine = dispatch * gate[..., None, None]
    return dispatch, combine


def moe_layer(x: torch.Tensor, router_w: torch.Tensor, expert_fn: Callable,
              expert_params: Sequence[torch.Tensor], *,
              axis_name: str = "ep", capacity_factor: float = 1.25
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-MoE layer over the ep axis. x: (T, D) this rank's tokens;
    router_w: (D, E_global) f32, replicated; ``expert_params``: this
    rank's experts' tensors with a leading E_local axis;
    ``expert_fn(params, tokens) -> tokens`` applies the experts (outside
    a mesh once per expert on (C, D) tokens, inside one once for all
    ranks and experts on (..., E_local, n*C, D), the reference's
    ``vmap``). Returns (output (T, D) in x's dtype, the load-balancing
    aux loss, an f32 scalar)."""
    n = axes.axis_size_or_1(axis_name)
    lead = axes.lead(x)
    t, dmodel = x.shape[-2:]
    e_global = router_w.shape[-1]
    if e_global % n:
        raise ValueError(f"{e_global} experts not divisible by ep={n}")
    e_local = e_global // n
    capacity = max(1, int(capacity_factor * t / e_global))

    logits = axes.rank_matmul(x.float(), router_w.float())
    dispatch, combine = _one_hot_dispatch(logits, e_global, capacity)

    # load-balancing aux loss (Switch eq. 4): E * sum_e f_e * p_e, with
    # f_e from the router's argmax BEFORE capacity dropping
    probs = torch.softmax(logits, dim=-1)
    pre_drop = F.one_hot(logits.argmax(dim=-1), e_global).float()
    aux = axes.pmean(e_global * torch.sum(pre_drop.mean(dim=-2)
                                          * probs.mean(dim=-2), dim=-1),
                     axis_name)

    # local tokens -> (E, C, D) expert queues -> (n, E_local, C, D)
    sent = torch.einsum("...tec,...td->...ecd", dispatch, x.float())
    ranks = sent.shape[:lead]
    recv = axes.all_to_all(
        sent.reshape(ranks + (n, e_local, capacity, dmodel)), axis_name,
        split_axis=0, concat_axis=0)  # each rank keeps its experts' queues
    per_expert = recv.transpose(-4, -3).reshape(
        recv.shape[:lead] + (e_local, n * capacity, dmodel)).to(x.dtype)
    if lead:
        done = expert_fn(tuple(expert_params), per_expert)
    else:
        done = torch.stack([
            expert_fn(tuple(p[e] for p in expert_params), per_expert[e])
            for e in range(e_local)])
    done = done.reshape(done.shape[:lead]
                        + (e_local, n, capacity, dmodel)).transpose(-4, -3)
    back = axes.all_to_all(done.float(), axis_name, split_axis=0,
                           concat_axis=0)  # route back
    back = back.reshape(back.shape[:lead] + (e_global, capacity, dmodel))
    out = torch.einsum("...tec,...ecd->...td", combine, back)
    return out.to(x.dtype), aux


def dropless_moe(comm, tokens, assignments, expert_fn: Callable,
                 n_experts: int) -> List[torch.Tensor]:
    """Dropless expert routing over ``alltoallv``: uneven capacities.

    :func:`moe_layer` pays for static shapes with token dropping; this
    driver-mode path is the exact-count alternative: the per-(rank,
    rank) token counts become an alltoallv count matrix
    (``coll_tuned_alltoallv.c``'s own use case), so no token is dropped.
    (The kernel under alltoallv still pads each chunk to the capped
    max count; what this path buys is exactness, not wire volume.)

    tokens[i]: (T_i, D) rank i's tokens (ragged T_i); assignments[i]:
    (T_i,) global expert ids; expert ``e`` lives on rank
    ``e // (n_experts // n)``. ``expert_fn(e, x)`` applies expert e to
    (K, D) tokens. Returns per-rank (T_i, D) outputs in original token
    order, on the comm's device. The counts are computed on the host;
    tokens move only on the device (and over the wire between
    processes).

    On a communicator SPANNING controller processes (the unified
    ``tpurun`` world) each process acts only as its LOCAL member ranks:
    pass one tokens/assignments entry per local member (the hier
    v-collective convention); the count matrix is completed with an
    allgather before routing.
    """
    from ..coll.driver import as_rank_buffer

    n = comm.size
    if n_experts % n:
        raise ValueError(f"{n_experts} experts not divisible by {n} ranks")
    e_local = n_experts // n
    acting = (list(comm.local_comm_ranks)
              if getattr(comm, "spans_processes", False) else list(range(n)))
    if len(tokens) != len(acting) or len(assignments) != len(acting):
        raise ValueError(
            f"dropless_moe: need one tokens and assignments entry per "
            f"acting rank ({len(acting)}), got {len(tokens)} tokens / "
            f"{len(assignments)} assignments"
        )
    dev = comm.device
    toks = [as_rank_buffer(t, dev) for t in tokens]
    assign = [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
              .astype(np.int32).reshape(-1) for a in assignments]
    d = toks[0].shape[1] if toks[0].dim() == 2 else 1

    # sort each rank's tokens by destination rank (stable keeps the
    # order within a destination, which the inverse permutation needs)
    owners = [a // e_local for a in assign]
    order = [np.argsort(o, kind="stable") for o in owners]
    local_counts = np.stack([np.bincount(o, minlength=n) for o in owners]
                            ).astype(np.int64)
    if len(acting) == n:
        counts = local_counts
    else:
        # complete the (n, n) matrix: every process contributes its
        # members' rows in comm-rank order (int32 on the wire, as the
        # JAX package sends them)
        gathered = comm.allgather(local_counts.astype(np.int32))
        counts = np.asarray(torch.as_tensor(gathered)[0].cpu()).reshape(
            n, n).astype(np.int64)
    order_dev = [torch.from_numpy(o).to(dev) for o in order]
    sendbufs = [t.reshape(-1, d).index_select(0, o).reshape(-1)
                for t, o in zip(toks, order_dev)]
    recv = comm.alltoallv(sendbufs, counts * d)
    # the expert ids travel alongside (same counts, 1 element per token)
    recv_ids = comm.alltoallv(
        [torch.from_numpy(a[o]).to(dev) for a, o in zip(assign, order)],
        counts)

    # each acting rank runs its local experts on the exact token set
    processed = []
    for pos, j in enumerate(acting):
        rt = recv[pos].reshape(-1, d)
        ids = recv_ids[pos]
        out = torch.empty_like(rt)
        for e in range(j * e_local, (j + 1) * e_local):
            sel = (ids == e).nonzero().reshape(-1)
            if sel.numel():
                out[sel] = expert_fn(e, rt.index_select(0, sel)).to(rt.dtype)
        processed.append(out.reshape(-1))

    # route back: the return count matrix is the transpose
    back = comm.alltoallv(processed, counts.T * d)
    outputs = []
    for pos in range(len(acting)):
        inv = torch.empty_like(order_dev[pos])
        inv[order_dev[pos]] = torch.arange(order_dev[pos].numel(),
                                           device=dev)
        outputs.append(back[pos].reshape(-1, d).index_select(0, inv))
    return outputs
