"""The roofline functions give PERF.md section 6's counts at its shapes."""

from benchmark.roofline import kernels as r


def test_encode_canon_bytes_at_the_count_batch():
    assert r.encode_canon_bytes(65536, 160, 25) == 81_788_928


def test_window_hits_bytes_at_the_filter_batch():
    assert r.window_hits_bytes(65536, 160, 2498, 1) == 21_515_792


def test_sw_batch_cells_and_bound():
    cells = 256 * 160 * 288
    assert cells == 11_796_480
    assert r.sw_batch_ops(cells) == 15 * cells
    assert abs(r.INT32_OPS_PER_S - 16.727e12) < 1e9
    # PERF.md section 6: 0.010578512396694214 ms
    assert abs(r.ops_seconds(r.sw_batch_ops(cells)) * 1e3
               - 0.010578512396694214) < 1e-9


def test_bytes_bound_uses_the_hbm_peak():
    # PERF.md section 6: encode_canon's bound 0.024414605373134328 ms
    assert abs(r.bytes_seconds(81_788_928) * 1e3
               - 0.024414605373134328) < 1e-12
