"""Launch of the Gaussian S·A CUDA kernel (``csrc/sketch_apply.cu``, entry
``repro_sketch_apply``) and of the Gaussian adjoint kernel (``csrc/adjoint.cu``).

``gaussian_tiles`` is the counterpart of the reference's ``kernels/gaussian/kernel.py``
``gaussian_tiles``: S·X on the tensor cores in fp32-accurate 3xTF32 form, S drawn
in-core once per cluster of column tiles (its own plan, ``cuda.plan_apply``, so
its S·X agrees with the one the Gram kernel contracts to rounding, not bitwise).
``gaussian_adjoint_tiles`` is the counterpart of the reference's
``kernels/gaussian/gram.py`` ``gaussian_adjoint_tiles``: Sᵀ·Y with S drawn in-core
from the same (key, i, j) counter stream. ``gaussian_tiles_keep`` is the S·X of
one key that also writes the S it draws, for the adjoint that reads it back
(``cuda.gaussian_adjoint_kept``, called from ``ops`` directly: the same function
as the reference's kernel with S read instead of drawn). The Gaussian stream
uses ``REPRO_RNG_ROUNDS`` threefry rounds.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import common, cuda


def gaussian_tiles(keys: torch.Tensor, X: torch.Tensor, m: int, *,
                   launches: collections.Counter, name: str, row0: int = 0) -> torch.Tensor:
    """(q, m, d) sketches S_w X of the CUDA tensor X (n, d) float32 for (q, 2) key
    words (``S_w[:, row0 : row0 + n]·X`` with ``row0``); ``launches[name]`` gains
    one per call into the kernel's C entry."""
    return cuda.sketch_apply("gaussian", keys, X, m, rounds=common.rng_rounds(),
                             launches=launches, name=name, row0=row0)


def gaussian_adjoint_tiles(key: torch.Tensor, Y: torch.Tensor, n: int, *,
                           launches: collections.Counter, name: str) -> torch.Tensor:
    """Sᵀ·Y (n, k) for the CUDA tensor Y (m, k) float32 and the (2,) key words of
    S ∈ R^{m×n}; ``launches[name]`` gains one per call into the kernel's C entry."""
    return cuda.gaussian_adjoint(key, Y, n, rounds=common.rng_rounds(), launches=launches, name=name)


def gaussian_tiles_keep(key: torch.Tensor, X: torch.Tensor, m: int, *,
                        launches: collections.Counter, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(S X, S)`` for the CUDA tensor X (n, d) float32 and the (2,) key words:
    S X (m, d) bitwise :func:`gaussian_tiles`'s, and S (m, ld) as the kernel drew
    it (columns ``:n``; ``cuda.kept_sketch_ld``). ``launches[name]`` gains one."""
    S = torch.empty((m, cuda.kept_sketch_ld(X.shape[0])), dtype=torch.float32, device=X.device)
    SX = cuda.sketch_apply("gaussian", key.reshape(1, 2), X, m, rounds=common.rng_rounds(),
                           launches=launches, name=name, s_out=S)
    return SX[0], S
