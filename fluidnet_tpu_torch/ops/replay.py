"""Gradients of a fused kernel by replaying its plain composition.

The JAX package gives each fused Pallas kernel a custom VJP that
differentiates the unfused XLA composition it replaces (forces_kernel.py
_fb_bwd / _vc_bwd, prologue.py _pro_bwd, advect_fast.py _fused_step_bwd).
`replay(kernel, ref, *xs)` is that rule in PyTorch: the forward runs
`kernel(*xs)`, the backward runs `ref(*xs)` again under autograd and takes
its vector-Jacobian product. Only the tensors `xs` get gradients; whatever
else the two functions read is closed over and held constant.
"""

import torch


class _Replay(torch.autograd.Function):

    @staticmethod
    def forward(ctx, kernel, ref, *xs):
        ctx.ref = ref
        ctx.save_for_backward(*xs)
        return kernel(*xs)

    @staticmethod
    def backward(ctx, *grads):
        xs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inp = [x.detach().requires_grad_(n) for x, n in zip(xs, need)]
            outs = ctx.ref(*inp)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(inp, need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       wrt, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and wrt else [None] * len(wrt))
        return (None, None) + tuple(next(got) if n else None for n in need)


def needs_grad(*xs):
    """Whether autograd records a function of the tensors xs (None allowed).
    The kernels' autograd.Functions are skipped otherwise: their host cost
    per call counts on the host-bound inference steps."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in xs)


def replay(kernel, ref, *xs):
    """kernel(*xs), whose gradient with respect to the tensors xs is that of
    ref(*xs). Both return a tensor or a tuple of tensors of the same
    shapes."""
    if not needs_grad(*xs):
        return kernel(*xs)
    return _Replay.apply(kernel, ref, *xs)
