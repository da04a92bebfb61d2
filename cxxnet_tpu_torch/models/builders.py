"""Conf-text builders for the model zoo.

Counterpart of ``cxxnet_tpu/models/builders.py``, copied function for
function so that each builder emits the same conf text as the JAX
package's (the tests hold them equal, character for character).
``dev = tpu`` in that text means the card to the port
(``nnet.trainer.resolve_device``).  A conf whose layers the port lacks
still raises ``NotImplementedError`` when its net is built.
"""

from __future__ import annotations

from typing import List


def _iter_block(
    kind: str, nsample: int, input_shape: str, nclass: int, threadbuffer: bool = False
) -> str:
    """A synthetic data/eval section (benchmarks; real runs swap in
    mnist/imgbin sections with the same keys)."""
    tb = "iter = threadbuffer\n" if threadbuffer else ""
    return (
        f"{kind} = {'train' if kind == 'data' else 'test'}\n"
        "iter = synthetic\n"
        f"  nsample = {nsample}\n"
        f"  input_shape = {input_shape}\n"
        f"  nclass = {nclass}\n"
        "  label_width = 1\n"
        f"{tb}iter = end\n"
    )


def _tail(
    batch_size: int,
    input_shape: str,
    num_round: int,
    eta: float = 0.01,
    extra: str = "",
    dev: str = "tpu",
    scan_steps: int = 8,
) -> str:
    # scan_steps: the CLI runs k batches as ONE device program
    # (doc/tasks.md); the trainer ignores the key in programmatic use
    return (
        f"input_shape = {input_shape}\n"
        f"batch_size = {batch_size}\n"
        f"dev = {dev}\n"
        f"num_round = {num_round}\n"
        f"max_round = {num_round}\n"
        "updater = sgd\n"
        f"eta = {eta}\n"
        "momentum = 0.9\n"
        "wd = 0.0005\n"
        f"scan_steps = {scan_steps}\n"
        "metric = error\n"
        "eval_train = 1\n"
        "print_step = 100\n"
        f"{extra}"
    )


# ---------------------------------------------------------------------------
def mnist_mlp_conf(
    batch_size: int = 100, synthetic: bool = True, dev: str = "tpu"
) -> str:
    """3-layer MLP (MNIST.conf parity: fullc 160 → sigmoid → fullc 10)."""
    data = (
        _iter_block("data", 6400, "1,1,784", 10)
        + _iter_block("eval", 1600, "1,1,784", 10)
        if synthetic
        else ""
    )
    return data + (
        "netconfig = start\n"
        "layer[0->1] = fullc:fc1\n"
        "  nhidden = 160\n"
        "  init_sigma = 0.01\n"
        "layer[1->2] = sigmoid:se1\n"
        "layer[2->3] = fullc:fc2\n"
        "  nhidden = 10\n"
        "  init_sigma = 0.01\n"
        "layer[3->3] = softmax\n"
        "netconfig = end\n"
    ) + _tail(batch_size, "1,1,784", 15, eta=0.1, dev=dev, extra="wd = 0.0\n")


def mnist_conv_conf(
    batch_size: int = 100, synthetic: bool = True, dev: str = "tpu"
) -> str:
    """LeNet-style conv net (MNIST_CONV.conf parity)."""
    data = (
        _iter_block("data", 6400, "1,28,28", 10)
        + _iter_block("eval", 1600, "1,28,28", 10)
        if synthetic
        else ""
    )
    return data + (
        "netconfig = start\n"
        "layer[0->1] = conv:cv1\n"
        "  kernel_size = 3\n"
        "  pad = 1\n"
        "  stride = 2\n"
        "  nchannel = 32\n"
        "  random_type = xavier\n"
        "  no_bias = 0\n"
        "layer[1->2] = max_pooling\n"
        "  kernel_size = 3\n"
        "  stride = 2\n"
        "layer[2->3] = flatten\n"
        "layer[3->3] = dropout\n"
        "  threshold = 0.5\n"
        "layer[3->4] = fullc:fc1\n"
        "  nhidden = 100\n"
        "  init_sigma = 0.01\n"
        "layer[4->5] = sigmoid:se1\n"
        "layer[5->6] = fullc:fc2\n"
        "  nhidden = 10\n"
        "  init_sigma = 0.01\n"
        "layer[6->6] = softmax\n"
        "netconfig = end\n"
    ) + _tail(batch_size, "1,28,28", 15, eta=0.1, dev=dev, extra="wd = 0.0\n")


# ---------------------------------------------------------------------------
def alexnet_conf(
    batch_size: int = 256,
    num_class: int = 1000,
    synthetic: bool = True,
    nsample: int = 0,
    dev: str = "tpu",
    input_size: int = 227,
    compute_dtype: str = "bfloat16",
) -> str:
    """AlexNet (ImageNet.conf parity: grouped convs, LRN, dropout FCs).

    ``input_size`` shrinks the input for CPU-feasible fixtures (ceil-mode
    pooling keeps every stage valid down to ~67px); 227 is the paper/
    reference shape."""
    shape = f"3,{input_size},{input_size}"
    nsample = nsample or batch_size * 4
    data = (
        _iter_block("data", nsample, shape, num_class, threadbuffer=True)
        + _iter_block("eval", batch_size * 2, shape, num_class)
        if synthetic
        else ""
    )
    lrn = (
        "  local_size = 5\n"
        "  alpha = 0.001\n"
        "  beta = 0.75\n"
        "  knorm = 1\n"
    )
    net = (
        "netconfig = start\n"
        "layer[0->1] = conv:conv1\n"
        "  kernel_size = 11\n  stride = 4\n  nchannel = 96\n"
        "layer[1->2] = relu\n"
        "layer[2->3] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        "layer[3->4] = lrn\n" + lrn +
        "layer[4->5] = conv:conv2\n"
        "  ngroup = 2\n  nchannel = 256\n  kernel_size = 5\n  pad = 2\n"
        "layer[5->6] = relu\n"
        "layer[6->7] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        "layer[7->8] = lrn\n" + lrn +
        "layer[8->9] = conv:conv3\n"
        "  nchannel = 384\n  kernel_size = 3\n  pad = 1\n"
        "layer[9->10] = relu\n"
        "layer[10->11] = conv:conv4\n"
        "  nchannel = 384\n  ngroup = 2\n  kernel_size = 3\n  pad = 1\n"
        "layer[11->12] = relu\n"
        "layer[12->13] = conv:conv5\n"
        "  nchannel = 256\n  ngroup = 2\n  kernel_size = 3\n  pad = 1\n"
        "  init_bias = 1.0\n"
        "layer[13->14] = relu\n"
        "layer[14->15] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        "layer[15->16] = flatten\n"
        "layer[16->17] = fullc:fc6\n"
        "  nhidden = 4096\n  init_sigma = 0.005\n  init_bias = 1.0\n"
        "layer[17->18] = relu\n"
        "layer[18->18] = dropout\n  threshold = 0.5\n"
        "layer[18->19] = fullc:fc7\n"
        "  nhidden = 4096\n  init_sigma = 0.005\n  init_bias = 1.0\n"
        "layer[19->20] = relu\n"
        "layer[20->20] = dropout\n  threshold = 0.5\n"
        f"layer[20->21] = fullc:fc8\n  nhidden = {num_class}\n"
        "layer[21->21] = softmax\n"
        "netconfig = end\n"
    )
    extra = (
        "metric = rec@1\nmetric = rec@5\n"
        "wmat:lr = 0.01\nwmat:wd = 0.0005\n"
        "bias:wd = 0.000\nbias:lr = 0.02\n"
        "lr:schedule = expdecay\nlr:gamma = 0.1\nlr:step = 100000\n"
        f"compute_dtype = {compute_dtype}\n"
    )
    return data + net + _tail(batch_size, shape, 45, eta=0.01, dev=dev, extra=extra)


# ---------------------------------------------------------------------------
def _inception(x: str, m: str, c1: int, c3r: int, c3: int, c5r: int, c5: int,
               cp: int) -> str:
    """One GoogLeNet inception module: 4 branches ch_concat'd to node m."""

    def conv(src: str, dst: str, tag: str, k: int, ch: int, pad: int) -> str:
        # kaiming, not xavier: every branch conv feeds a relu, and xavier
        # halves activation variance per relu layer — measured signal
        # collapse of ~2x per inception block by i5b (the vanishing the
        # paper's auxiliary heads existed to patch); He-init keeps the
        # forward signal unit-scale through all 9 modules
        return (
            f"layer[{src}->{dst}] = conv:{tag}\n"
            f"  kernel_size = {k}\n  nchannel = {ch}\n  pad = {pad}\n"
            "  random_type = kaiming\n"
        )

    s = conv(x, f"{m}_c1", f"{m}_1x1", 1, c1, 0)
    s += f"layer[+1:{m}_b1] = relu\n"
    s += conv(x, f"{m}_c3r", f"{m}_3x3r", 1, c3r, 0)
    s += f"layer[+1:{m}_b2r] = relu\n"
    s += conv(f"{m}_b2r", f"{m}_c3", f"{m}_3x3", 3, c3, 1)
    s += f"layer[+1:{m}_b2] = relu\n"
    s += conv(x, f"{m}_c5r", f"{m}_5x5r", 1, c5r, 0)
    s += f"layer[+1:{m}_b3r] = relu\n"
    s += conv(f"{m}_b3r", f"{m}_c5", f"{m}_5x5", 5, c5, 2)
    s += f"layer[+1:{m}_b3] = relu\n"
    s += (
        f"layer[{x}->{m}_p] = max_pooling\n"
        "  kernel_size = 3\n  stride = 1\n  pad = 1\n"
    )
    s += conv(f"{m}_p", f"{m}_pp", f"{m}_pool_proj", 1, cp, 0)
    s += f"layer[+1:{m}_b4] = relu\n"
    s += f"layer[{m}_b1,{m}_b2,{m}_b3,{m}_b4->{m}] = ch_concat\n"
    return s


def googlenet_conf(
    batch_size: int = 128,
    num_class: int = 1000,
    input_size: int = 224,
    synthetic: bool = True,
    nsample: int = 0,
    dev: str = "tpu",
    compute_dtype: str = "bfloat16",
) -> str:
    """GoogLeNet (inception v1) — the BASELINE.json benchmark model.

    Szegedy et al. 2014, table 1; main classifier only (the two auxiliary
    heads exist for vanishing-gradient relief the TPU build doesn't need
    at this depth; they are train-time-only and dropped at inference).
    """
    shape = f"3,{input_size},{input_size}"
    nsample = nsample or batch_size * 4
    data = (
        _iter_block("data", nsample, shape, num_class, threadbuffer=True)
        + _iter_block("eval", batch_size * 2, shape, num_class)
        if synthetic
        else ""
    )
    lrn = (
        "  local_size = 5\n  alpha = 0.0001\n  beta = 0.75\n  knorm = 1\n"
    )
    net = (
        "netconfig = start\n"
        "layer[0->c1] = conv:conv1\n"
        "  kernel_size = 7\n  stride = 2\n  pad = 3\n  nchannel = 64\n"
        "  random_type = kaiming\n"
        "layer[+1:c1r] = relu\n"
        "layer[c1r->p1] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        "layer[p1->n1] = lrn\n" + lrn +
        "layer[n1->c2r] = conv:conv2_reduce\n"
        "  kernel_size = 1\n  nchannel = 64\n  random_type = kaiming\n"
        "layer[+1:c2rr] = relu\n"
        "layer[c2rr->c2] = conv:conv2\n"
        "  kernel_size = 3\n  pad = 1\n  nchannel = 192\n"
        "  random_type = kaiming\n"
        "layer[+1:c2a] = relu\n"
        "layer[c2a->n2] = lrn\n" + lrn +
        "layer[n2->p2] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        + _inception("p2", "i3a", 64, 96, 128, 16, 32, 32)
        + _inception("i3a", "i3b", 128, 128, 192, 32, 96, 64)
        + "layer[i3b->p3] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        + _inception("p3", "i4a", 192, 96, 208, 16, 48, 64)
        + _inception("i4a", "i4b", 160, 112, 224, 24, 64, 64)
        + _inception("i4b", "i4c", 128, 128, 256, 24, 64, 64)
        + _inception("i4c", "i4d", 112, 144, 288, 32, 64, 64)
        + _inception("i4d", "i4e", 256, 160, 320, 32, 128, 128)
        + "layer[i4e->p4] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        + _inception("p4", "i5a", 256, 160, 320, 32, 128, 128)
        + _inception("i5a", "i5b", 384, 192, 384, 48, 128, 128)
        + f"layer[i5b->pool5] = avg_pooling\n"
        f"  kernel_size = {max(1, input_size // 32)}\n  stride = 1\n"
        "layer[pool5->pool5] = dropout\n  threshold = 0.4\n"
        "layer[pool5->flat] = flatten\n"
        f"layer[flat->fc] = fullc:loss3_classifier\n"
        f"  nhidden = {num_class}\n  random_type = xavier\n"
        "layer[fc->fc] = softmax\n"
        "netconfig = end\n"
    )
    extra = (
        "metric = rec@1\nmetric = rec@5\n"
        "wmat:lr = 0.01\nwmat:wd = 0.0002\n"
        "bias:lr = 0.02\nbias:wd = 0.0\n"
        "lr:schedule = polydecay\nlr:alpha = 0.5\nlr:max_round = 2400000\n"
        f"compute_dtype = {compute_dtype}\n"
    )
    return data + net + _tail(batch_size, shape, 100, eta=0.01, dev=dev, extra=extra)


def _transformer_blocks(
    prev: str,
    nlayer: int,
    nhead: int,
    dim: int,
    causal: int,
    seq_parallel: int,
    attn_impl: str = "auto",
) -> tuple:
    """Shared pre-norm block emission for transformer_conf /
    transformer_lm_conf: layer_norm -> attention -> residual ->
    layer_norm -> 4x MLP -> residual, per block.  Returns
    ``(conf_text, last_node)``."""
    s = ""
    for i in range(nlayer):
        b = f"b{i}"
        s += (
            f"layer[{prev}->{b}_n1] = layer_norm:{b}_ln1\n"
            f"layer[{b}_n1->{b}_a] = attention:{b}_attn\n"
            f"  nhead = {nhead}\n"
            f"  causal = {causal}\n"
            f"  seq_parallel = {seq_parallel}\n"
            f"  attn_impl = {attn_impl}\n"
            "  init_sigma = 0.02\n"
            f"layer[{prev},{b}_a->{b}_r1] = eltwise_sum\n"
            f"layer[{b}_r1->{b}_n2] = layer_norm:{b}_ln2\n"
            f"layer[{b}_n2->{b}_h] = fullc:{b}_fc1\n"
            f"  nhidden = {dim * 4}\n  init_sigma = 0.02\n"
            f"layer[+1:{b}_g] = gelu\n"
            f"layer[{b}_g->{b}_o] = fullc:{b}_fc2\n"
            f"  nhidden = {dim}\n  init_sigma = 0.02\n"
            f"layer[{b}_r1,{b}_o->{b}_r2] = eltwise_sum\n"
        )
        prev = f"{b}_r2"
    return s, prev


def transformer_lm_conf(
    vocab: int = 256,
    seq_len: int = 128,
    dim: int = 128,
    nhead: int = 4,
    nlayer: int = 2,
    text_file: str = "",
    batch_size: int = 16,
    num_round: int = 10,
    seq_parallel: int = 0,
    dev: str = "tpu",
    compute_dtype: str = "bfloat16",
    attn_impl: str = "auto",
    eta: float = 0.003,
) -> str:
    """Byte-level causal transformer language model.

    New TPU-first scope (the reference has no sequence models): the full
    LM pipeline — ``text`` iterator (byte windows + next-byte labels),
    ``embedding`` with learned positions, pre-norm causal blocks (flash
    attention via ``attn_impl``, sequence parallelism via
    ``seq_parallel``), a per-position softmax over the vocabulary, and
    per-token error/logloss metrics.  ``task = generate`` samples from a
    trained checkpoint (cli.py).
    """
    data = ""
    if text_file:
        data = (
            "data = train\n"
            "iter = text\n"
            f"  filename = {text_file}\n"
            f"  seq_len = {seq_len}\n"
            "  shuffle = 1\n"
            "iter = end\n"
        )
    s = (
        "netconfig = start\n"
        "layer[0->emb] = embedding:embed\n"
        f"  nvocab = {vocab}\n"
        f"  nhidden = {dim}\n"
        "  pos = learned\n"
        "  init_sigma = 0.02\n"
    )
    blocks, prev = _transformer_blocks(
        "emb", nlayer, nhead, dim, 1, seq_parallel, attn_impl
    )
    s += blocks
    s += (
        f"layer[{prev}->nf] = layer_norm:ln_f\n"
        f"layer[nf->logits] = fullc:lm_head\n"
        f"  nhidden = {vocab}\n  init_sigma = 0.02\n"
        "layer[logits->logits] = softmax\n"
        # per-token mean: the loss sums over T positions, so scale by
        # 1/T to keep eta in the familiar per-instance range
        f"  grad_scale = {1.0 / seq_len!r}\n"
        "netconfig = end\n"
    )
    extra = (
        f"compute_dtype = {compute_dtype}\n"
        f"label_width = {seq_len}\n"
        f"label_vec[0,{seq_len}) = label\n"
        "metric = logloss\n"
        # transformers want Adam; override _tail's sgd+momentum
        "updater = adam\n"
        "wd = 0.0\n"
    )
    return data + s + _tail(
        batch_size, f"1,1,{seq_len}", num_round, eta=eta, dev=dev,
        extra=extra,
    )


def _res_bottleneck(prev: str, name: str, cin: int, cmid: int, cout: int,
                    stride: int) -> str:
    """Bottleneck residual block: 1x1 reduce -> 3x3 -> 1x1 expand, each
    conv + batch_norm + relu (relu after the residual add), projection
    shortcut when shape changes (He et al. 2015)."""
    s = ""
    def cbr(src, dst, ch, k, st, pad, tag, relu=True):
        t = (
            f"layer[{src}->{dst}_c] = conv:{tag}_conv\n"
            f"  kernel_size = {k}\n  stride = {st}\n  pad = {pad}\n"
            f"  nchannel = {ch}\n  no_bias = 1\n  random_type = kaiming\n"
            f"layer[{dst}_c->{dst}] = batch_norm:{tag}_bn\n"
        )
        if relu:
            t += f"layer[{dst}->{dst}] = relu\n"
        return t

    s += cbr(prev, f"{name}_a", cmid, 1, stride, 0, f"{name}_a")
    s += cbr(f"{name}_a", f"{name}_b", cmid, 3, 1, 1, f"{name}_b")
    s += cbr(f"{name}_b", f"{name}_c", cout, 1, 1, 0, f"{name}_c",
             relu=False)
    if cin != cout or stride != 1:
        s += cbr(prev, f"{name}_p", cout, 1, stride, 0, f"{name}_proj",
                 relu=False)
        short = f"{name}_p"
    else:
        short = prev
    s += (
        f"layer[{short},{name}_c->{name}] = eltwise_sum\n"
        f"layer[{name}->{name}] = relu\n"
    )
    return s


_RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet101_conf(**kw) -> str:
    """ResNet-101 — the [3, 4, 23, 3] depth of He et al. 2015 table 1."""
    return resnet50_conf(depth=101, **kw)


def resnet152_conf(**kw) -> str:
    """ResNet-152 — the [3, 8, 36, 3] depth of He et al. 2015 table 1."""
    return resnet50_conf(depth=152, **kw)


def resnet50_conf(
    batch_size: int = 128,
    num_class: int = 1000,
    input_size: int = 224,
    synthetic: bool = True,
    nsample: int = 0,
    dev: str = "tpu",
    compute_dtype: str = "bfloat16",
    depth: int = 50,
) -> str:
    """ResNet-50/101/152 (He et al. 2015, table 1) — bottleneck blocks,
    batch-norm everywhere, projection shortcuts at stage boundaries.
    New-scope zoo entry (the reference predates ResNets); built from the
    paper like the GoogLeNet/VGG entries.  ``depth`` picks the stage
    plan (50: [3,4,6,3], 101: [3,4,23,3], 152: [3,8,36,3]).
    """
    if input_size % 32:
        raise ValueError(
            f"resnet50_conf: input_size={input_size} must be a multiple "
            "of 32 (the stage chain downsamples 5x; anything else leaves "
            "the final avg pool non-global)"
        )
    shape = f"3,{input_size},{input_size}"
    nsample = nsample or batch_size * 4
    data = (
        _iter_block("data", nsample, shape, num_class, threadbuffer=True)
        + _iter_block("eval", batch_size * 2, shape, num_class)
        if synthetic
        else ""
    )
    net = (
        "netconfig = start\n"
        "layer[0->c1] = conv:conv1\n"
        "  kernel_size = 7\n  stride = 2\n  pad = 3\n  nchannel = 64\n"
        "  no_bias = 1\n  random_type = kaiming\n"
        "layer[c1->b1] = batch_norm:bn1\n"
        "layer[b1->b1] = relu\n"
        # pad 0: the framework's ceil-shape pooling (reference parity)
        # with pad 1 would give 57x57; unpadded k3 s2 on 112 lands on
        # the paper's 56x56
        "layer[b1->p1] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
    )
    prev, cin = "p1", 64
    if depth not in _RESNET_BLOCKS:
        raise ValueError(
            f"resnet depth must be one of {sorted(_RESNET_BLOCKS)}, "
            f"got {depth}"
        )
    b0, b1, b2, b3 = _RESNET_BLOCKS[depth]
    stages = [(b0, 64, 256, 1), (b1, 128, 512, 2), (b2, 256, 1024, 2),
              (b3, 512, 2048, 2)]
    for si, (blocks, cmid, cout, stride) in enumerate(stages):
        for bi in range(blocks):
            name = f"s{si}b{bi}"
            st = stride if bi == 0 else 1
            net += _res_bottleneck(prev, name, cin, cmid, cout, st)
            prev, cin = name, cout
    net += (
        f"layer[{prev}->pool] = avg_pooling\n"
        f"  kernel_size = {max(1, input_size // 32)}\n  stride = 1\n"
        "layer[pool->flat] = flatten\n"
        f"layer[flat->fc] = fullc:fc1000\n"
        f"  nhidden = {num_class}\n  random_type = xavier\n"
        "layer[fc->fc] = softmax\n"
        "netconfig = end\n"
    )
    extra = (
        "metric = rec@1\nmetric = rec@5\n"
        "wmat:lr = 0.1\nwmat:wd = 0.0001\n"
        # one-pass E[x^2]-E[x]^2 batch-norm statistics: the 53 BNs read
        # their activations once instead of twice (stats in f32 either
        # way); measured 68.3 -> 63.6 ms/step on the v5e b128 step
        # (doc/performance.md ResNet bisection)
        "bn_stats = onepass\n"
        f"compute_dtype = {compute_dtype}\n"
    )
    return data + net + _tail(batch_size, shape, 90, eta=0.1, dev=dev,
                              extra=extra)



# ---------------------------------------------------------------------------
def vgg19_conf(**kw) -> str:
    """VGG-19 (configuration E, Simonyan & Zisserman 2014)."""
    return vgg16_conf(depth=19, **kw)


def vgg16_conf(
    batch_size: int = 64,
    num_class: int = 1000,
    input_size: int = 224,
    synthetic: bool = True,
    nsample: int = 0,
    dev: str = "tpu",
    compute_dtype: str = "bfloat16",
    depth: int = 16,
) -> str:
    """VGG-16/19 (configurations D/E, Simonyan & Zisserman 2014)."""
    shape = f"3,{input_size},{input_size}"
    nsample = nsample or batch_size * 4
    data = (
        _iter_block("data", nsample, shape, num_class, threadbuffer=True)
        + _iter_block("eval", batch_size * 2, shape, num_class)
        if synthetic
        else ""
    )
    blocks: List[str] = []
    node = "0"
    idx = 0
    if depth == 16:
        plan = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    elif depth == 19:
        plan = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]
    else:
        raise ValueError(f"vgg depth must be 16 or 19, got {depth}")
    for b, (reps, ch) in enumerate(plan, start=1):
        for r in range(1, reps + 1):
            dst = f"c{b}_{r}"
            blocks.append(
                f"layer[{node}->{dst}] = conv:conv{b}_{r}\n"
                f"  kernel_size = 3\n  pad = 1\n  nchannel = {ch}\n"
                "  random_type = xavier\n"
                f"layer[+1:{dst}r] = relu\n"
            )
            node = f"{dst}r"
            idx += 1
        blocks.append(
            f"layer[{node}->pool{b}] = max_pooling\n"
            "  kernel_size = 2\n  stride = 2\n"
        )
        node = f"pool{b}"
    net = (
        "netconfig = start\n"
        + "".join(blocks)
        + f"layer[{node}->flat] = flatten\n"
        "layer[flat->f6] = fullc:fc6\n"
        "  nhidden = 4096\n  init_sigma = 0.01\n"
        "layer[+1:f6r] = relu\n"
        "layer[f6r->f6r] = dropout\n  threshold = 0.5\n"
        "layer[f6r->f7] = fullc:fc7\n"
        "  nhidden = 4096\n  init_sigma = 0.01\n"
        "layer[+1:f7r] = relu\n"
        "layer[f7r->f7r] = dropout\n  threshold = 0.5\n"
        f"layer[f7r->f8] = fullc:fc8\n  nhidden = {num_class}\n"
        "  init_sigma = 0.01\n"
        "layer[f8->f8] = softmax\n"
        "netconfig = end\n"
    )
    extra = (
        "metric = rec@1\nmetric = rec@5\n"
        f"compute_dtype = {compute_dtype}\n"
    )
    return data + net + _tail(batch_size, shape, 74, eta=0.01, dev=dev, extra=extra)


# ---------------------------------------------------------------------------
def kaggle_bowl_conf(
    batch_size: int = 64, synthetic: bool = True, dev: str = "tpu",
    compute_dtype: str = "float32",
) -> str:
    """NDSB plankton convnet (bowl.conf parity: 40×40×3, 121 classes).

    Default stays f32 (the net is tiny — its 5-minute-GPU-training-run
    claim is the BASELINE target, and logloss parity matters more than
    step time); pass ``compute_dtype="bfloat16"`` for throughput runs.
    """
    shape = "3,40,40"
    data = (
        _iter_block("data", 3200, shape, 121)
        + _iter_block("eval", 640, shape, 121)
        if synthetic
        else ""
    )
    net = (
        "netconfig = start\n"
        "layer[0->1] = conv:conv1\n"
        "  kernel_size = 5\n  pad = 2\n  nchannel = 32\n"
        "  random_type = xavier\n"
        "layer[1->2] = relu\n"
        "layer[2->3] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        "layer[3->4] = conv:conv2\n"
        "  kernel_size = 3\n  pad = 1\n  nchannel = 64\n"
        "  random_type = xavier\n"
        "layer[4->5] = relu\n"
        "layer[5->6] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        "layer[6->7] = conv:conv3\n"
        "  kernel_size = 3\n  pad = 1\n  nchannel = 128\n"
        "  random_type = xavier\n"
        "layer[7->8] = relu\n"
        "layer[8->9] = conv:conv4\n"
        "  kernel_size = 3\n  pad = 1\n  nchannel = 128\n"
        "  random_type = xavier\n"
        "layer[9->10] = relu\n"
        "layer[10->11] = max_pooling\n  kernel_size = 3\n  stride = 2\n"
        "layer[11->12] = flatten\n"
        "layer[12->13] = fullc:fc1\n"
        "  nhidden = 512\n  init_sigma = 0.01\n"
        "layer[13->14] = relu\n"
        "layer[14->14] = dropout\n  threshold = 0.5\n"
        "layer[14->15] = fullc:fc2\n"
        "  nhidden = 121\n  init_sigma = 0.01\n"
        "layer[15->15] = softmax\n"
        "netconfig = end\n"
    )
    extra = (
        "metric = logloss\n"
        f"compute_dtype = {compute_dtype}\n"
    )
    return data + net + _tail(batch_size, shape, 100, eta=0.01, dev=dev, extra=extra)


# ---------------------------------------------------------------------------
def transformer_conf(
    batch_size: int = 32,
    seq_len: int = 128,
    dim: int = 128,
    nhead: int = 4,
    nlayer: int = 2,
    num_class: int = 10,
    causal: int = 0,
    seq_parallel: int = 0,
    synthetic: bool = False,
    nsample: int = 0,
    dev: str = "tpu",
    compute_dtype: str = "bfloat16",
    pipeline_parallel: int = 0,
    n_microbatch: int = 4,
    attn_impl: str = "auto",
) -> str:
    """Pre-norm transformer encoder classifier over dense sequences.

    New TPU-first scope (the reference has no sequence models): blocks of
    layer_norm -> attention -> residual -> layer_norm -> mlp -> residual,
    then mean pooling and a softmax head.  ``seq_parallel=1`` runs ring
    attention with the sequence sharded over the mesh model axis
    (``ops/attention.py``).

    ``pipeline_parallel >= 1`` declares the SAME block stack as a
    ``pipe_transformer`` layer (stacked params) so it can run as a GPipe
    pipeline over the mesh model axis; ``pipeline_parallel = 1`` keeps
    pipelining off (plain scanned stack) with identical math — the
    parity pair for tests.
    """
    nsample = nsample or batch_size * 4
    data = ""
    if synthetic:
        for kind, n in (("data", nsample), ("eval", batch_size * 2)):
            data += (
                f"{kind} = {'train' if kind == 'data' else 'test'}\n"
                "iter = synthetic\n"
                f"  nsample = {n}\n"
                f"  input_shape = 1,{seq_len},{dim}\n"
                f"  nclass = {num_class}\n"
                "  layout = seq\n"
                "iter = end\n"
            )
    s = "netconfig = start\n"
    if pipeline_parallel >= 1 and seq_parallel:
        raise ValueError(
            "transformer_conf: seq_parallel (ring attention) and "
            "pipeline_parallel are mutually exclusive — both shard over "
            "the mesh model axis"
        )
    if pipeline_parallel >= 1:
        s += (
            "layer[0->blocks] = pipe_transformer:blocks\n"
            f"  nblock = {nlayer}\n"
            f"  nhead = {nhead}\n"
            f"  causal = {causal}\n"
            f"  ffn_hidden = {dim * 4}\n"
            f"  pipeline_parallel = {1 if pipeline_parallel > 1 else 0}\n"
            f"  n_microbatch = {n_microbatch}\n"
            "  init_sigma = 0.02\n"
        )
        prev = "blocks"
        per_layer_blocks = range(0)
    else:
        prev = "0"
        per_layer_blocks = range(nlayer)
    if len(per_layer_blocks):
        blocks, prev = _transformer_blocks(
            prev, nlayer, nhead, dim, causal, seq_parallel, attn_impl
        )
        s += blocks
    s += (
        f"layer[{prev}->pool] = seq_pool\n"
        f"layer[pool->fc] = fullc:head\n"
        f"  nhidden = {num_class}\n  init_sigma = 0.02\n"
        "layer[fc->fc] = softmax\n"
        "netconfig = end\n"
        "input_layout = seq\n"
    )
    extra = f"compute_dtype = {compute_dtype}\n"
    if pipeline_parallel > 1:
        extra += f"model_parallel = {pipeline_parallel}\n"
    return data + s + _tail(
        batch_size, f"1,{seq_len},{dim}", 10, eta=0.01, dev=dev, extra=extra
    )
