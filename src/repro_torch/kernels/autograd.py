"""A kernel's forward under autograd, with its plain version's backward.

None of the five kernels has a backward kernel (nor has the JAX package:
its models differentiate their plain jnp formulations). A wrapper
returns a fresh tensor with no ``grad_fn``, so a model that trains
through it would get no gradient past it. ``kernel_call`` closes that
gap: where autograd needs a gradient, the forward is the kernel and the
backward recomputes the plain version on the saved inputs and returns
``torch.autograd.grad`` of it. Elsewhere (serving, the simulator, CUDA
graphs) it calls the kernel and nothing more.
"""

from __future__ import annotations

import torch
from torch.autograd.profiler import record_function


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on ``tensors``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


class _PlainGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, name, *inputs):
        ctx.plain, ctx.name = plain, name
        ctx.save_for_backward(*inputs)
        outs = kernel(*inputs)
        ctx.single = isinstance(outs, torch.Tensor)
        outs = (outs,) if ctx.single else tuple(outs)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        return outs[0] if ctx.single else outs

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        want = ctx.needs_input_grad[3:]
        with torch.enable_grad(), record_function(
                f"{ctx.name} plain backward"):
            xs = [x.detach().requires_grad_(w) for x, w in zip(inputs, want)]
            outs = ctx.plain(*xs)
            outs = (outs,) if ctx.single else tuple(outs)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            wrt = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return (None, None, None) + tuple(next(got) if w else None
                                          for w in want)


def kernel_call(kernel, plain, *inputs, name="kernel"):
    """``kernel(*inputs)``: a tensor or a tuple of tensors. Where grad
    mode is on and an input requires grad, the call is recorded with
    ``plain``'s VJP: ``plain(*inputs)`` must compute the same outputs
    (its integer ones aside, which are not differentiable), and the
    backward recomputes it on the saved inputs. The forward value is
    the kernel's, bit for bit. ``name`` labels the backward's profiler
    range ("<name> plain backward")."""
    if not needs_grad(*inputs):
        return kernel(*inputs)
    return _PlainGrad.apply(kernel, plain, name, *inputs)
