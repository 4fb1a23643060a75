"""The operation counts of `ovbench/work.py`, pinned."""
from ovbench import harness, work


def test_dense_and_attention():
    assert work.dense(10, 3, 4) == 240.0
    # scores and value product of 2 scenes, 5 queries, 7 keys, width 8
    assert work.attention(2, 5, 7, 8) == 2 * (2 * 2 * 5 * 7 * 8)


def test_set_abstraction_mlp():
    m = harness.config("ov_sunrgbd")["model"]
    # the pre-encoder's shared MLP alone: 3 -> 64 -> 128 -> 256 on B x 2048 x 64 rows
    rows = 8 * 2048 * 64
    want = 2.0 * rows * (3 * 64 + 64 * 128 + 128 * 256)
    assert work._mlp(rows, [3, *m["preenc_mlp"][:-1], m["encoder"]["dim"]]) == want


def test_int8_conv():
    t = dict(width=80, layers=[4, 6, 10, 6], roi_chunk_regions=256, pooler_resolution=18)
    convs = {c[0]: c for c in work.teacher_convs(t, 8, 530, 730, 1024)}
    name, prec, ops, nbytes, calls = convs["stem.conv2"]
    rows = 8 * 265 * 365
    assert (prec, calls) == ("int8", 1)
    assert ops == 2.0 * rows * 40 * 9 * 40
    assert nbytes == rows * 40 + 40 * 360 + 8 * 40 + rows * 40
    assert convs["layer4.block0.conv2"][4] == 4  # the res5 convs once a chunk of 256


def test_teacher_forward_bound():
    """The forward's 141 int8 conv calls sum to the 7.532 ms bound that
    PERF.md's kernel table gives at 1979 TOP/s and 3.35 TB/s."""
    t = harness.config("ov_sunrgbd")["teacher"]
    convs = [c for c in work.teacher_convs(t, 8, 530, 730, 1024) if c[1] == "int8"]
    assert sum(c[4] for c in convs) == 141
    assert abs(work.conv_seconds(convs) * 1e3 - 7.532) < 0.0005
    res5_3x3 = [c for c in convs if c[0].startswith("layer4") and c[0].endswith("conv2")]
    assert abs(work.conv_seconds(res5_3x3) * 1e3 - 2.781) < 0.0005


def test_step_counts():
    ov, masked = harness.config("ov_sunrgbd"), harness.config("scannet_masked")
    assert work.train_step_seconds(ov) > work.train_step_seconds(masked) > 0
    assert 0 < work.trunk_seconds(ov) < work.train_step_seconds(ov)
