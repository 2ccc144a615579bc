"""Special functions torch lacks.

``betainc`` is the regularized incomplete beta function I_x(a, b), the
counterpart of ``jax.scipy.special.betainc`` as the step detector uses it
(ops/stepfit_batch.py: the two-tailed Student-t p-value is
I_{df/(df+t^2)}(df/2, 1/2)). ``torch.special`` has the incomplete gamma
functions only.
"""

from __future__ import annotations

import torch

# Continued-fraction rounds. The fraction converges in O(sqrt(max(a, b)))
# rounds once x is on the right side of the mean; a converged fraction is a
# fixpoint of further rounds, so a fixed count costs time, not accuracy.
# 100 rounds reach float64 round-off for a, b up to a few thousand.
BETAINC_ROUNDS = 100


def betainc(a, b, x):
    """I_x(a, b) for tensors (or scalars) a, b > 0 and 0 <= x <= 1,
    elementwise with broadcasting, in the tensors' floating dtype.

    The continued fraction of the incomplete beta (modified Lentz
    evaluation) with the reflection I_x(a, b) = 1 - I_{1-x}(b, a) where
    x > (a + 1) / (a + b + 2). Exactly ``BETAINC_ROUNDS`` rounds run whatever
    the data, so nothing is read back from the device. NaN in gives NaN out.
    """
    tensors = [t for t in (a, b, x) if isinstance(t, torch.Tensor)]
    like = tensors[0]
    dtype = like.dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    if not dtype.is_floating_point:
        dtype = torch.get_default_dtype()
    a, b, x = (torch.as_tensor(t, dtype=dtype, device=like.device)
               for t in (a, b, x))
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1.0) / (a + b + 2.0)
    a, b, x = (torch.where(swap, b, a), torch.where(swap, a, b),
               torch.where(swap, 1.0 - x, x))
    tiny = torch.finfo(dtype).tiny

    def guard(v):
        return torch.where(v.abs() < tiny, torch.full_like(v, tiny), v)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / guard(1.0 - qab * x / qap)
    h = d
    for m in range(1, BETAINC_ROUNDS + 1):
        m2 = 2.0 * m
        # Even step of the recurrence.
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
        # Odd step.
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + aa * d)
        c = guard(1.0 + aa / c)
        h = h * d * c
    log_front = (a * torch.log(x) + b * torch.log1p(-x) + torch.lgamma(qab)
                 - torch.lgamma(a) - torch.lgamma(b))
    out = torch.exp(log_front) * h / a
    return torch.where(swap, 1.0 - out, out)
