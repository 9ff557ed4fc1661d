"""What a remat policy keeps of the attention kernels (counterpart of
k_diffusion_tpu/ops/pallas/remat_names.py) and the autograd Function the
attention wrappers share.

Under ``torch.utils.checkpoint`` a layer's forward runs twice: once in the
forward pass, whose saved tensors are dropped, and again in the backward
(the recompute) to get them back. The JAX package names the attention
kernels' residuals (``ATTN_OUT``: the output and the per-head logsumexp;
``ATTN_QKV``: q, k, v) so that a ``save_only_these_names`` policy keeps
them and the rematerialised backward reads them instead of re-running the
attention forward. The kernels here are bound through ``ctypes``, not as
dispatcher ops, so torch's selective checkpointing cannot see them; a
``Stash`` does the same: ``layers.remat`` opens one for a layer run under
a ``save_*`` policy, each attention call of the layer's forward keeps its
output and logsumexp in it (and q, k, v with ``keep_qkv``), and the
recompute takes them back, in call order, with no launch. Its backward then
reads the kept tensors, which equal what a re-run would give bit for bit.
"""

import contextlib
import threading

import torch

# the Stash of the checkpointed layer this thread runs now, if any (the
# recompute may run in autograd's device thread)
_current = threading.local()


class Stash:
    """The attention residuals of one checkpointed layer call: a list of
    (out, lse) or (out, lse, q, k, v), appended in the forward and read in
    the same order by the recompute."""

    def __init__(self, keep_qkv=False):
        self.keep_qkv = keep_qkv
        self.kept = []
        self.replaying = False
        self.next = 0


@contextlib.contextmanager
def recording(stash, replay):
    """Makes ``stash`` the current one: the attention calls inside keep
    their residuals in it, or with ``replay`` read them back in order."""
    previous = getattr(_current, "stash", None)
    _current.stash = stash
    stash.replaying, stash.next = replay, 0
    try:
        yield
    finally:
        _current.stash = previous


class _Attention(torch.autograd.Function):
    """``forward(q, k, v) -> (out, lse)``, ``backward(q, k, v, out, lse,
    dout) -> (dq, dk, dv)``: the attention kernels' autograd node, saving
    q, k, v, the output and the logsumexp, as the JAX custom_vjps do. Under
    a ``Stash`` the forward keeps its residuals or, in the recompute, reads
    them back instead of calling ``forward``."""

    @staticmethod
    def forward(ctx, q, k, v, forward, backward):
        stash = getattr(_current, "stash", None)
        if stash is not None and stash.replaying:
            kept = stash.kept[stash.next]
            stash.next += 1
            out, lse = kept[0].detach(), kept[1]
            if stash.keep_qkv:
                q, k, v = kept[2:]
        else:
            out, lse = forward(q, k, v)
            if stash is not None:
                kept = (out.detach(), lse)
                if stash.keep_qkv:
                    kept += tuple(t.detach() for t in (q, k, v))
                stash.kept.append(kept)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.backward_fn = backward
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*ctx.backward_fn(q, k, v, out, lse, dout), None, None)


def attention(q, k, v, forward, backward):
    """A differentiable attention call through the kernels ``forward`` and
    ``backward`` (see ``_Attention``)."""
    return _Attention.apply(q, k, v, forward, backward)


def plain(q, k, v, reference, reference_backward):
    """A plain version on CPU tensors: ``reference(q, k, v)`` differentiated
    by autograd, or inside a layer under a ``save_*`` policy, a node whose
    backward is ``reference_backward(q, k, v, dout)``, so that the
    recompute reads the kept output as the kernels' path does."""
    if getattr(_current, "stash", None) is None:
        return reference(q, k, v)
    return attention(
        q, k, v, lambda q, k, v: (reference(q, k, v), None),
        lambda q, k, v, out, lse, dout: reference_backward(q, k, v, dout))
