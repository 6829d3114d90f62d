"""Small traffic of each cell's kind, for runs of the harness on the CPU
(the port's plain versions) in the tests."""

import pytest

SMALL = {
    "dat_to_cd.madi_block": {"entry": "block", "channels": 4,
                             "samples": 8192, "inputs": 2},
    "arb_farrow.capture_block": {"entry": "block", "channels": 1,
                                 "samples": 16384, "inputs": 2},
    "dat_to_cd.pcm_stream": {"entry": "stream", "dtype": "int16",
                             "pcm_rms": 0.2, "chunk_min": 10,
                             "chunk_max": 300, "block_size": 1024,
                             "pool_samples": 65536},
    "arb_farrow.sdr_stream": {"entry": "stream", "dtype": "float32",
                              "chunk_min": 100, "chunk_max": 700,
                              "block_size": 2048, "pool_samples": 65536},
}
SEED = 2 ** 31 + 12345  # past 32 signed bits, as a run's seed may be


@pytest.fixture(params=sorted(SMALL))
def cell_name(request):
    return request.param
