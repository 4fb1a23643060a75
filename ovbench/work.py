"""The yardstick: the chip's published peaks and the work of a step or a
request, counted from the configuration's shapes.

Counted: the matrix products and convolutions (2 operations a
multiply-add), at the precision the configuration runs each in.  The
count does not depend on which kernel runs, so a later change to the
program cannot move it.  A training step counts the detector's forward
three times (the backward twice the forward of trained layers) and the
frozen teacher's forward once.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 1979 TOP/s
int8, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM3.
"""
from __future__ import annotations

BF16_PEAK = 989e12
INT8_PEAK = 1979e12
F32_PEAK = 67e12
HBM_BYTES_PER_S = 3.35e12

_PEAKS = {"bfloat16": BF16_PEAK, "float32": F32_PEAK, "int8": INT8_PEAK}


def dense(rows: int, cin: int, cout: int) -> float:
    """Operations of a (rows, cin) x (cin, cout) product."""
    return 2.0 * rows * cin * cout


def attention(B: int, NQ: int, NK: int, dim: int) -> float:
    """Scores and the value product of multi-head attention, all heads."""
    return 2 * 2.0 * B * NQ * NK * dim


def _layer(B, NQ, NK, d, ffn, self_attn=True) -> float:
    """One transformer layer's products: q, k, v and out projections, the
    attention, the two FFN matrices."""
    rows_q, rows_k = B * NQ, B * NK
    return (dense(rows_q, d, d) * 2 + dense(rows_k, d, d) * 2 + attention(B, NQ, NK, d)
            + dense(rows_q, d, ffn) + dense(rows_q, ffn, d))


def _mlp(rows: int, dims: list) -> float:
    return sum(dense(rows, a, b) for a, b in zip(dims[:-1], dims[1:]))


def detector_forward(m: dict, B: int) -> float:
    """Operations of one forward of the 3DETR detector on B scenes."""
    enc, dec = m["encoder"], m["decoder"]
    d, N = enc["dim"], m["preenc_npoints"]
    cin = 3 + (3 if m["use_color"] else 0)
    ops = _mlp(B * N * m["preenc_nsample"], [cin, *m["preenc_mlp"][:-1], d])
    if enc["kind"] == "masked":
        M = N // 2
        ops += _layer(B, N, N, d, enc["ffn_dim"])
        ops += _mlp(B * M * m["interim_nsample"], [3 + d, *m["interim_mlp"][:-1], d])
        ops += (enc["num_layers"] - 1) * _layer(B, M, M, d, enc["ffn_dim"])
        N, proj = M, [d, d, dec["dim"]]
    else:
        ops += enc["num_layers"] * _layer(B, N, N, d, enc["ffn_dim"])
        proj = [d, d, d, dec["dim"]]
    ops += _mlp(B * N, proj)
    Q, dd = m["num_queries"], dec["dim"]
    ops += dense(B * (Q + N), 3, dd // 2) + _mlp(B * Q, [dd, dd, dd])
    ops += dec["num_layers"] * (_layer(B, Q, Q, dd, dec["ffn_dim"])
                                + dense(B * Q, dd, dd) * 2 + dense(B * N, dd, dd) * 2
                                + attention(B, Q, N, dd))
    rows = dec["num_layers"] * B * Q
    for out in (m["clip_embed_dim"], 3, 3, m["num_angle_bin"], m["num_angle_bin"]):
        ops += _mlp(rows, [dd, dd, dd, out])
    ops += dense(rows, m["clip_embed_dim"], m["num_semcls"] + 1)
    return ops


def teacher_convs(t: dict, B: int, H: int, W: int, regions: int) -> list:
    """Every conv call of one teacher forward as (name, precision,
    operations, bytes, calls): the stem's conv1 in bf16, the 141 trunk and
    res5 calls in int8, the res5 convs once a chunk of `roi_chunk_regions`
    regions.  Bytes are the least a W8A8 chain moves: the int8 input and
    kernel and the f32 scales read once, a residual read in bf16, and each
    output written once, in bf16 where a bf16 consumer reads it (a block's
    output, a downsample's identity, a conv before a pool) and in int8
    where only the next conv does."""
    w = t["width"]
    out = []

    def conv(name, prec, rows, cin, cout, k, calls=1, res=False, bf16_out=False, int8_out=True):
        K = cin * k * k
        nbytes = rows * cin + cout * K + 8 * cout + (2 * rows * cout if res else 0) \
            + (2 * rows * cout if bf16_out else 0) + (rows * cout if int8_out else 0)
        out.append((name, prec, 2.0 * rows * K * cout, float(nbytes), calls))

    h, wd = (H + 1) // 2, (W + 1) // 2  # conv1, stride 2, padding 1
    conv("stem.conv1", "bfloat16", B * h * wd, 3, w // 2, 3, bf16_out=True, int8_out=False)
    conv("stem.conv2", "int8", B * h * wd, w // 2, w // 2, 3)
    conv("stem.conv3", "int8", B * h * wd, w // 2, w, 3, bf16_out=True, int8_out=False)
    h, wd = h // 2, wd // 2

    def stage(scope, n, inplanes, planes, blocks, stride, h, wd, calls=1, last=False):
        for i in range(blocks):
            cin = inplanes if i == 0 else planes * 4
            s = stride if i == 0 else 1
            conv(f"{scope}.block{i}.conv1", "int8", n * h * wd, cin, planes, 1, calls)
            conv(f"{scope}.block{i}.conv2", "int8", n * h * wd, planes, planes, 3, calls,
                 bf16_out=s > 1, int8_out=s == 1)
            ho, wo = h // s, wd // s
            tail = last and i == blocks - 1
            conv(f"{scope}.block{i}.conv3", "int8", n * ho * wo, planes, planes * 4, 1, calls,
                 res=True, bf16_out=True, int8_out=not tail)
            if i == 0 and (s > 1 or cin != planes * 4):
                conv(f"{scope}.block{i}.downsample_conv", "int8", n * ho * wo, cin, planes * 4,
                     1, calls, bf16_out=True, int8_out=False)
            h, wd = ho, wo
        return h, wd

    L = t["layers"]
    h, wd = stage("layer1", B, w, w, L[0], 1, h, wd)
    h, wd = stage("layer2", B, 4 * w, 2 * w, L[1], 2, h, wd)
    stage("layer3", B, 8 * w, 4 * w, L[2], 2, h, wd, last=True)
    if regions:
        chunk = max(1, min(regions // B, t["roi_chunk_regions"] // B)) * B
        calls = -(-regions // chunk)
        P = t["pooler_resolution"]
        stage("layer4", chunk, 16 * w, 8 * w, L[3], 2, P, P, calls, last=True)
    return out


def conv_seconds(convs: list) -> float:
    """The least seconds of these conv calls: each at the larger of its
    operations at its precision's peak and its bytes at the HBM rate."""
    return sum(calls * max(ops / _PEAKS[prec], nbytes / HBM_BYTES_PER_S)
               for _, prec, ops, nbytes, calls in convs)


def teacher_trunk_convs(t: dict, B: int, H: int, W: int) -> list:
    """The conv calls of the profiler range "trunk": the backbone after conv1."""
    return [c for c in teacher_convs(t, B, H, W, 0) if c[0] != "stem.conv1"]


def teacher_head_other(t: dict, regions: int) -> float:
    """bf16 operations of the attention pool a forward (the single query
    folded: q, the key fold, the logits and pooled sum over the P/2 x P/2 + 1
    tokens, the value and output projections)."""
    C = 32 * t["width"]
    heads = C // 64
    tokens = (t["pooler_resolution"] // 2) ** 2 + 1
    return (dense(regions, C, C) * 3 + 2 * 2.0 * regions * heads * tokens * C
            + dense(regions, C, t["embed_dim"]))


def trunk_pass_bytes(t: dict, B: int, H: int, W: int) -> float:
    """Bytes the trunk's quantise passes move at the least: each reads its
    bf16 input once and writes each int8 output once (the stem's bn1 and
    ReLU pass, the stem's pool, and each strided stage's two pools)."""
    w = t["width"]
    h, wd = (H + 1) // 2, (W + 1) // 2
    total = B * h * wd * (w // 2) * (2 + 1)  # bn1 + ReLU + quantise
    q = B * (h // 2) * (wd // 2) * w
    total += B * h * wd * w * 2 + q * 2  # the stem's pool, two int8 forms
    h, wd = h // 2, wd // 2
    for planes, cin in ((2 * w, 4 * w), (4 * w, 8 * w)):
        total += B * h * wd * planes * 2 + B * (h // 2) * (wd // 2) * planes
        total += B * h * wd * cin * 2 + B * (h // 2) * (wd // 2) * cin
        h, wd = h // 2, wd // 2
    return total


def seconds_at_peak(ops_by_precision: dict) -> float:
    return sum(ops / _PEAKS[p] for p, ops in ops_by_precision.items())


def train_step_seconds(cfg: dict) -> float:
    """The least seconds of one training step at the published peaks."""
    m, data = cfg["model"], cfg["data"]
    B = data["batch_size_per_device"]
    det = 3.0 * detector_forward(m, B)
    work = {m["compute_dtype"]: det}
    t = cfg["teacher"]
    if t.get("enabled"):
        from ovbench.scenes import IMG_H, IMG_W
        regions = B * m["num_queries"]
        for _, prec, ops, _, calls in teacher_convs(t, B, IMG_H, IMG_W, regions):
            work[prec] = work.get(prec, 0.0) + ops * calls
        work["bfloat16"] = work.get("bfloat16", 0.0) + teacher_head_other(t, regions)
    return seconds_at_peak(work)


def request_seconds(cfg: dict, scenes: int) -> float:
    """The least seconds of one detection request's forward at peak."""
    m = cfg["model"]
    return seconds_at_peak({m["compute_dtype"]: detector_forward(m, scenes)})


def trunk_seconds(cfg: dict) -> float:
    """The least seconds of the teacher's "trunk" range: its int8 convs
    (`conv_seconds`) plus its quantise passes' bytes at the HBM rate."""
    from ovbench.scenes import IMG_H, IMG_W
    t, B = cfg["teacher"], cfg["data"]["batch_size_per_device"]
    return (conv_seconds(teacher_trunk_convs(t, B, IMG_H, IMG_W))
            + trunk_pass_bytes(t, B, IMG_H, IMG_W) / HBM_BYTES_PER_S)
