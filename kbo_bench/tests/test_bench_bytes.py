"""The roofline yardstick against hand counts."""

from kbo_bench.metrics import _bytes


def test_key_bytes():
    assert _bytes.key_bytes(51) == 13  # 102 bits
    assert _bytes.key_bytes(31) == 8  # 62 bits
    assert _bytes.key_bytes(4) == 1


def test_map_request_bytes():
    # 100 indexed bases in two contigs, 80 streamed, k = 51:
    # 100 read + 100 rows x 13 B written and read + 80 read + 80 written
    assert _bytes.request_bytes(51, [60, 40], False, [80]) == (
        100 + 2 * 100 * 13 + 80 + 80)


def test_find_counts_both_strands_rows_once_each():
    assert _bytes.request_bytes(51, [100], True, [10, 20]) == (
        100 + 2 * 200 * 13 + 2 * 30)


def test_screen_reads_a_standing_index_once_and_builds_nothing():
    # 100 indexed positions on both strands, k = 51, reads of 80 and 70:
    # 200 rows x 13 B read + 150 bases read + 150 bytes written
    assert _bytes.screen_bytes(51, 100, True, [80, 70]) == (
        200 * 13 + 150 + 150)
    assert _bytes.screen_bytes(51, 100, False, [10]) == 100 * 13 + 20
