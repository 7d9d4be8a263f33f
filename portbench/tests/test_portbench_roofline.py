"""The frozen counts against a count by hand."""
import pytest
import torch

from portbench import roofline

# 5 rows over 6 features (column 5 the intercept), padded to 4 slots;
# column counts: 0:3, 1:2, 2:1, 3:2, 4:1, 5:5
IND = torch.tensor([[0, 1, 5, 0],
                    [0, 3, 5, 0],
                    [2, 5, 0, 0],
                    [1, 3, 4, 5],
                    [0, 5, 0, 0]], dtype=torch.int32)
VAL = (torch.tensor([[1, 1, 1, 0],
                     [1, 1, 1, 0],
                     [1, 1, 0, 0],
                     [1, 1, 1, 1],
                     [1, 1, 0, 0]]) * 1.0).float()


def test_counts_by_hand():
    # hot: the 2 most frequent columns, 5 (5 ids) and 0 (3 ids);
    # tail entries: row 0 {1}, row 1 {3}, row 2 {2}, row 3 {1, 3, 4}
    c = roofline.count_data(IND, VAL, 6, 2, 2)
    assert (c.rows, c.n_features, c.d_dense) == (5, 6, 2)
    assert c.tail_nnz == 6
    assert c.tail_columns == 4   # 1, 2, 3, 4
    assert c.tail_rows == 4      # rows 0-3


def test_ties_go_to_the_lower_column():
    # columns 1 and 3 tie at 2 ids each for the third hot place
    c = roofline.count_data(IND, VAL, 6, 3, 2)
    assert c.tail_nnz == 4        # column 1 is hot: 3, 2, 3, 4 stay
    assert c.tail_columns == 3


@pytest.mark.parametrize("lanes", [1, 8])
def test_work_by_hand(lanes):
    c = roofline.count_data(IND, VAL, 6, 2, 2)
    tail = roofline.tail_matvec(c, lanes)
    assert tail.bytes == 6 * 8 + 4 * lanes * (4 + 4)
    assert tail.flops == 2 * 6 * lanes
    rmv = roofline.bucket_rmatvec(c, lanes)
    assert rmv.bytes == tail.bytes and rmv.flops == tail.flops
    hot = roofline.hot_product(c, lanes)
    assert hot.bytes == 5 * 2 * 2
    assert hot.dense_flops == 2 * 5 * 2 * lanes
    # 4 iterations, history 2: slots held 0, 1, 2, 2
    hist = roofline.history_sweeps(c, lanes, 4, 2)
    assert hist.bytes == 2 * 5 * 6 * lanes * 4
    assert hist.flops == 4 * 2 * 5 * 6 * lanes
    fit = roofline.fit_work(c, lanes, 3, 2, 4, 2)
    want = (hot + tail) * 3 + (hot + rmv) * 2 + hist
    assert fit == want


def test_least_time_takes_the_larger_bound():
    w = roofline.Work(bytes=3.35e12, dense_flops=0.0, flops=0.0)
    assert w.least_s() == (1.0, "bytes")
    w = roofline.Work(bytes=0.0, dense_flops=989e12, flops=67e12)
    assert w.least_s() == (2.0, "flops")
