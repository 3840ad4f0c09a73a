"""The trace's reductions on hand-made records: device operations with
step kernels at their launch counts, busy time as the union of records,
and the breakdown's idle gaps labelled by the innermost host
operation."""
from eci_bench import trace


DEV = [("void credit_rank_kernel(...)", 0.0, 2.0),
       ("elementwise_kernel<where>", 2.0, 10.0),
       ("elementwise_kernel<where>", 9.0, 12.0),     # overlaps: union
       ("void count_fold_kernel<1>(...)", 20.0, 24.0)]
HOST = [("aten::where", 11.0, 30.0), ("aten::copy_", 13.0, 18.0)]


def test_tally_counts_dropped_kernel_records_by_launches():
    t = trace._tally(DEV, {"credit_rank": 3, "count_fold": 1})
    assert t["ops"] == 2 + 3 + 1
    assert t["us"] == 8.0 + 3.0 + 3 * 2.0 + 4.0
    assert t["kernels"] == {"credit_rank": (1, 2.0), "count_fold": (1, 4.0)}


def test_busy_is_the_union_of_records():
    assert trace._busy(DEV) == (12.0 + 4.0) / 1e6


def test_breakdown_labels_gaps_by_innermost_host_op():
    b = trace.breakdown(DEV, HOST)
    assert b["device_ops"][0] == ["elementwise_kernel<where>", 11.0 / 1e6]
    assert b["idle_gaps"] == [["aten::copy_", 8.0 / 1e6]]
