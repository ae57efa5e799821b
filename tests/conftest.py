"""Test bootstrap: a minimal deterministic `hypothesis` shim.

The container does not ship `hypothesis`; the property tests only use
``given`` / ``settings`` / ``strategies.{integers,sampled_from}``. When the
real library is absent we install a tiny deterministic stand-in that draws
``max_examples`` samples from a seeded PRNG — the property tests still
exercise many shapes, just without shrinking/replay.
"""

import random
import sys
import types


def _install_hypothesis_stub():
    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def sample(self, rng):
            return self._draw(rng)

    def integers(min_value, max_value):
        return _Strategy(lambda rng: rng.randint(min_value, max_value))

    def sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda rng: rng.choice(elements))

    def floats(min_value=0.0, max_value=1.0, **_):
        return _Strategy(lambda rng: rng.uniform(min_value, max_value))

    def booleans():
        return _Strategy(lambda rng: rng.random() < 0.5)

    def lists(elem, min_size=0, max_size=8, **_):
        return _Strategy(
            lambda rng: [elem.sample(rng)
                         for _ in range(rng.randint(min_size, max_size))]
        )

    def settings(**kwargs):
        def deco(fn):
            setattr(fn, "_stub_settings", kwargs)
            return fn

        return deco

    def given(*strategies, **kw_strategies):
        def deco(fn):
            def wrapper(*args, **kwargs):
                conf = (getattr(wrapper, "_stub_settings", None)
                        or getattr(fn, "_stub_settings", {}))
                n = int(conf.get("max_examples", 10))
                rng = random.Random(0)
                for _ in range(n):
                    drawn = [s.sample(rng) for s in strategies]
                    drawn_kw = {k: s.sample(rng)
                                for k, s in kw_strategies.items()}
                    fn(*args, *drawn, **kwargs, **drawn_kw)

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    mod = types.ModuleType("hypothesis")
    mod.given = given
    mod.settings = settings
    st = types.ModuleType("hypothesis.strategies")
    st.integers = integers
    st.sampled_from = sampled_from
    st.floats = floats
    st.booleans = booleans
    st.lists = lists
    mod.strategies = st
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st


try:  # pragma: no cover - depends on environment
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover
    _install_hypothesis_stub()


def pytest_configure(config):
    # pytest-timeout is installed in CI (hard hang caps on the serve
    # jobs) but not in the base container; register the marker so local
    # runs don't warn about it
    config.addinivalue_line(
        "markers",
        "timeout(seconds): hard wall-clock cap, enforced when "
        "pytest-timeout is installed")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device; skipped on machines without one")
