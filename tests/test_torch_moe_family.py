"""Port parity for internlm2, qwen3-moe (qk-norm, every layer MoE: the
grouped expert launch at G = 8 on the smoke config) and arctic (MoE with
the parallel dense residual) at their smoke configs: the family-
parametrised tests of ``tests/test_torch_decoder_family.py`` (prefill and
decode in three modes, ``convert`` round trips, bucketed engine against
the B = 1 loop, engine tokens against the JAX engine) over these three
families, in a file of their own so test workers take the two halves
apart. Tolerances and inputs are that file's.
"""

import pytest

from test_torch_decoder_family import (  # noqa: F401  (collected here)
    FAMILIES, HERE, _setup, test_bucketed_matches_b1,
    test_convert_round_trip, test_engine_tokens_match_reference,
    test_prefill_and_decode_match_reference)
import test_torch_threads  # noqa: F401  (one thread budget per worker)

THERE = tuple(f for f in FAMILIES if f not in HERE)


@pytest.fixture(scope="module", params=THERE)
def family(request):
    return (request.param,) + _setup(request.param)


def test_the_two_files_cover_every_family():
    assert THERE == ("internlm2", "qwen3_moe", "arctic")
