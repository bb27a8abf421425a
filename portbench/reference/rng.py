"""RNG discipline for the host-side DES.

The reference couples each node (server/source) to its own
``np.random.RandomState`` stream reseeded per replication from a master
stream (reference: simulation_v3.py:446-456), and draws service /
interarrival times through *scipy frozen distributions*
(simulation_v3.py:181-199, 263-276).

We reproduce the exact draw sequences while skipping scipy's per-call
overhead (~50us/rvs): each scipy frozen ``rvs(random_state=rng)`` reduces to
one documented call on the underlying legacy ``RandomState``:

    expon(scale=s).rvs(rng)                 == s * rng.standard_exponential()
    norm(loc=m, scale=s).rvs(rng)           == m + s * rng.standard_normal()
    uniform(loc=a, scale=w).rvs(rng)        == a + w * rng.random_sample()
    gamma(a, loc=l, scale=s).rvs(rng)       == l + s * rng.standard_gamma(a)
    beta(a, b, loc=l, scale=s).rvs(rng)     == l + s * rng.beta(a, b)
    rv_discrete(values=(xk, pk)).rvs(rng)   == ppf(rng.random_sample())

Bit-parity with scipy is asserted in tests/test_rng_parity.py.

Device-side randomness uses explicit ``torch.Generator`` objects; this module is
host-only by design (SURVEY.md section 5, "RNG management").
"""

from __future__ import annotations

import numpy as np

_SUPPORTED = (
    "exponential",
    "discrete",
    "uniform",
    "normal",
    "beta",
    "gamma",
    "branch",
    "queue",
)


class Sampler:
    """One node's service/interarrival distribution.

    ``spec`` is the reference's list form, e.g. ``['normal', loc, scale]``
    (simulation_v3.py:181-199). ``branch`` and ``queue`` are pseudo-kinds:
    ``branch`` always samples 0.0, ``queue`` has no distribution at all.
    """

    __slots__ = ("kind", "params", "_xk", "_cum", "mean", "_int_support")

    def __init__(self, spec):
        kind = spec[0]
        if kind not in _SUPPORTED:
            raise ValueError("Distribution not supported")
        self.kind = kind
        # float64 params: scipy's rvs promotes loc/scale to float64, and a
        # float32 param would keep the whole draw in float32 under NumPy 2's
        # weak scalar promotion (observed: low-bit divergence vs reference).
        if kind == "discrete":
            self.params = tuple(spec[1:])
        else:
            self.params = tuple(float(p) for p in spec[1:])
        self._xk = None
        self._cum = None

        if kind == "exponential":
            self.mean = float(spec[1])
        elif kind == "discrete":
            # scipy's rv_discrete.rvs dtype follows the support array:
            # integer xk -> int64 variates (which f-string-format as '2',
            # not '2.0', in the 'processing' log lines), float xk -> float64.
            self._int_support = np.issubdtype(np.asarray(spec[1]).dtype, np.integer)
            xk = np.asarray(spec[1], dtype=np.float64)
            pk = np.asarray(spec[2], dtype=np.float64)
            order = np.argsort(xk, kind="stable")
            self._xk = xk[order]
            self._cum = np.cumsum(pk[order])
            self.mean = float(np.sum(xk * pk))
        elif kind == "uniform":
            self.mean = float(spec[1]) + float(spec[2]) / 2.0
        elif kind == "normal":
            self.mean = float(spec[1])
        elif kind == "beta":
            a, b, loc, scale = map(float, spec[1:5])
            # parenthesized exactly as scipy evaluates it (mu = a/(a+b),
            # then loc + scale*mu) — (scale*a)/(a+b) differs by 1 ulp on
            # ~6% of parameter draws, visible in 'All'-mode mean lines
            self.mean = loc + scale * (a / (a + b))
        elif kind == "gamma":
            a, loc, scale = map(float, spec[1:4])
            self.mean = loc + scale * a
        else:  # branch / queue
            self.mean = 0.0

    @property
    def is_branch(self) -> bool:
        return self.kind == "branch"

    @property
    def is_queue(self) -> bool:
        return self.kind == "queue"

    def draw(self, rng: np.random.RandomState) -> float:
        """One variate; draw-for-draw identical to scipy frozen ``rvs``."""
        kind = self.kind
        if kind == "exponential":
            return self.params[0] * rng.standard_exponential()
        if kind == "normal":
            return self.params[0] + self.params[1] * rng.standard_normal()
        if kind == "uniform":
            return self.params[0] + self.params[1] * rng.random_sample()
        if kind == "gamma":
            a, loc, scale = self.params[:3]
            return loc + scale * rng.standard_gamma(a)
        if kind == "beta":
            a, b, loc, scale = self.params[:4]
            return loc + scale * rng.beta(a, b)
        if kind == "discrete":
            u = rng.random_sample()
            idx = int(np.searchsorted(self._cum, u, side="left"))
            idx = min(idx, len(self._xk) - 1)
            v = self._xk[idx]
            return int(v) if self._int_support else float(v)
        if kind == "branch":
            return 0.0
        raise ValueError("'queue' nodes have no distribution")


def spawn_node_seeds(master_seed: int, n_servers: int, n_sources: int):
    """Per-replication reseeding, matching simulation_v3.py:446-456.

    The master ``RandomState(seed)`` deals ``randint(3, 9999999)`` first to
    every server (in id order), then to every source. Returns
    ``(server_seeds, source_seeds)`` lists.
    """
    rng = np.random.RandomState(master_seed)
    server_seeds = [int(rng.randint(3, 9999999)) for _ in range(n_servers)]
    source_seeds = [int(rng.randint(3, 9999999)) for _ in range(n_sources)]
    return server_seeds, source_seeds
