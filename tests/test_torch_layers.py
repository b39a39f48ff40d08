"""The port's ``nn.Layer``, containers, hooks, ParamAttr and initializers,
state dicts and ``paddle.save``/``load`` against the JAX package: twins of
``tests/test_nn_layers.py``, C9 (Linear holds Paddle's ``[in, out]``
weight), ``create_parameter`` with each initializer, state-dict names and
order, and a ``.pdparams`` checkpoint carried across the two packages in
both directions (a small GPT, a small ResNet with its batch-norm
buffers)."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.utils import unique_name

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from tests.torch_port_util import gpt_pair, port_cpu  # noqa: F401

pytestmark = pytest.mark.usefixtures("port_cpu")

C9_TOL = 1e-6


# ------------------------------------------------------------------ C9 ----

@pytest.mark.parametrize("shape", [(4, 4), (4, 3)], ids=["square", "rect"])
def test_c9_linear_takes_paddles_in_out_weight(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(5, shape[0]).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    b = rng.randn(shape[1]).astype(np.float32)
    for bias in (None, b):
        want = JF.linear(jp.to_tensor(x), jp.to_tensor(w),
                         None if bias is None else jp.to_tensor(bias))
        got = F.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                       None if bias is None else paddle.to_tensor(bias))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=C9_TOL,
                                   rtol=C9_TOL)
        # and on plain torch tensors, as the port's layers call it
        plain = F.linear(torch.from_numpy(x), torch.from_numpy(w),
                         None if bias is None else torch.from_numpy(bias))
        np.testing.assert_allclose(plain.numpy(), want.numpy(), atol=C9_TOL,
                                   rtol=C9_TOL)
    jl = jnn.Linear(*shape)
    tl = nn.Linear(*shape)
    assert list(tl.weight.shape) == jl.weight.shape == list(shape)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    np.testing.assert_allclose(tl(paddle.to_tensor(x)).numpy(),
                               jl(jp.to_tensor(x)).numpy(), atol=C9_TOL,
                               rtol=C9_TOL)


def test_c9_linear_draws_xavier_normal_on_in_out():
    lin = nn.Linear(300, 200, generator=torch.Generator().manual_seed(0))
    assert tuple(lin.weight.shape) == (300, 200)
    want = math.sqrt(2.0 / 500)
    assert abs(float(lin.weight.detach().std()) / want - 1) < 0.02
    assert float(lin.bias.detach().abs().sum()) == 0.0


@pytest.mark.parametrize("padding_idx", [None, 0, 3, -1, -5, 7])
def test_embedding_padding_idx_matches_jax(padding_idx):
    """The rows at ``padding_idx`` (a negative one counts from the end) are
    zeros and take no gradient; one outside ``[-vocab, vocab)`` masks
    nothing, as in the JAX package. ``sparse`` gives the same numbers."""
    rng = np.random.RandomState(1)
    w = rng.randn(5, 3).astype(np.float32)
    ids = np.array([[0, 4, 3], [4, 1, 0]], np.int64)
    c = rng.randn(2, 3, 3).astype(np.float32)
    jw = jp.to_tensor(w, stop_gradient=False)
    jout = JF.embedding(jp.to_tensor(ids), jw, padding_idx=padding_idx)
    (jg,) = jp.grad((jout * jp.to_tensor(c)).sum(), [jw])
    for sparse in (False, True):
        pw = paddle.to_tensor(w, stop_gradient=False)
        pout = F.embedding(paddle.to_tensor(ids), pw,
                           padding_idx=padding_idx, sparse=sparse)
        (pg,) = paddle.grad((pout * paddle.to_tensor(c)).sum(), [pw])
        np.testing.assert_allclose(pout.numpy(), jout.numpy(), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(pg.numpy(), jg.numpy(), atol=1e-6,
                                   rtol=1e-6)
    if padding_idx in (0, -5):
        assert not pout.numpy()[ids == 0].any()
        assert not pg.numpy()[0].any()


def test_layer_norm_without_gamma_or_beta_matches_jax():
    """``weight_attr=False`` / ``bias_attr=False``, as in the JAX package,
    and a ``ParamAttr``'s name (since A7(a2))."""
    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    for wa, ba in ((False, None), (None, False), (False, False)):
        jl = jnn.LayerNorm(8, 1e-5, wa, ba)
        pl = nn.LayerNorm(8, 1e-5, wa, ba)
        assert [k for k, _ in pl.named_parameters()] == [
            k for k, _ in jl.named_parameters()]
        np.testing.assert_allclose(pl(paddle.to_tensor(x)).numpy(),
                                   jl(jp.to_tensor(x)).numpy(), atol=1e-5,
                                   rtol=1e-5)
    got = nn.LayerNorm(8, weight_attr=paddle.ParamAttr(name="g")).weight
    want = jnn.LayerNorm(8, weight_attr=jp.ParamAttr(name="g")).weight
    assert got.name == want.name == "g"


# ------------------------------------------- twins of test_nn_layers.py ----

def test_layer_registration_and_traversal():
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(4, 8)
            self.fc2 = nn.Linear(8, 2)
            self.act = nn.ReLU()

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    net = Net()
    names = [n for n, _ in net.named_parameters()]
    assert names == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
    assert len(net.sublayers()) == 3
    assert isinstance(net.parameters(), list)
    out = net(paddle.randn([2, 4]))
    assert isinstance(out, paddle.Tensor) and out.shape == [2, 2]
    plain = net(torch.randn(2, 4))          # plain in, plain out
    assert type(plain) is torch.Tensor


def test_train_eval_mode_propagates():
    net = nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1D(4))
    net.eval()
    assert not net[1].training
    x = paddle.ones([10, 4])
    np.testing.assert_allclose(net(x).numpy(), net(x).numpy())
    net.train()
    assert net[1].training


def test_state_dict_roundtrip():
    net = nn.Sequential(nn.Linear(3, 5), nn.BatchNorm1D(5))
    sd = net.state_dict()
    assert list(sd) == ["0.weight", "0.bias", "1.weight", "1.bias",
                        "1._mean", "1._variance"]
    net2 = nn.Sequential(nn.Linear(3, 5), nn.BatchNorm1D(5))
    assert net2.set_state_dict(sd) == ([], [])
    np.testing.assert_allclose(net2[0].weight.numpy(), net[0].weight.numpy())
    missing, unexpected = net2.set_state_dict({"0.weight": sd["0.weight"],
                                               "extra": sd["0.bias"]})
    assert "0.bias" in missing and unexpected == ["extra"]


def test_batchnorm_running_stats_update():
    bn = nn.BatchNorm1D(4, momentum=0.5)
    x = paddle.to_tensor(np.random.RandomState(0).randn(16, 4).astype(
        "float32") * 3 + 1)
    bn.train()
    bn(x)
    assert not np.allclose(bn._mean.numpy(), np.zeros(4))
    bn.eval()
    m0 = bn._mean.numpy().copy()
    bn(x)
    np.testing.assert_allclose(bn._mean.numpy(), m0)


def test_forward_hooks():
    lin = nn.Linear(2, 2)
    calls = []
    h1 = lin.register_forward_pre_hook(lambda layer, inp: calls.append("pre"))
    h2 = lin.register_forward_post_hook(
        lambda layer, inp, out: calls.append("post"))
    lin(paddle.ones([1, 2]))
    assert calls == ["pre", "post"]
    h1.remove()
    h2.remove()
    calls.clear()
    lin(paddle.ones([1, 2]))
    assert calls == []


def test_containers():
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    ll.append(nn.Linear(2, 2))
    assert len(ll) == 4 and len(ll.parameters()) == 8
    ll.insert(0, nn.ReLU())
    del ll[0]
    assert [n for n, _ in ll.named_children()] == ["0", "1", "2", "3"]
    pl = nn.ParameterList([paddle.create_parameter([2, 2], "float32")])
    assert len(pl.parameters()) == 1
    sd = nn.LayerDict({"a": nn.Linear(2, 2)})
    assert "a" in sd and list(sd.keys()) == ["a"]
    seq = nn.Sequential(("first", nn.Linear(2, 3)), ("act", nn.ReLU()))
    assert list(seq.state_dict()) == ["first.weight", "first.bias"]
    assert isinstance(seq[0], nn.Linear) and len(seq) == 2
    assert isinstance(seq[0:1], nn.Sequential)


def test_layer_to_dtype():
    net = nn.Linear(2, 2)
    net.to(dtype="bfloat16")
    assert net.weight.dtype == paddle.bfloat16
    net.to("float32")
    assert net.weight.dtype == torch.float32


def test_parameter_trainable_flag():
    lin = nn.Linear(2, 2)
    lin.weight.trainable = False
    lin(paddle.ones([1, 2])).sum().backward()
    assert lin.weight.grad is None
    assert lin.bias.grad is not None


def test_clear_gradients():
    lin = nn.Linear(2, 2)
    lin(paddle.ones([1, 2])).sum().backward()
    lin.clear_gradients()
    assert lin.weight.grad is None


def test_tied_torch_parameters_stay_one_object():
    emb = torch.nn.Embedding(5, 3)

    class Tied(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = emb
            self.head = emb.weight

    m = Tied()
    assert m.head is m.emb.weight and isinstance(m.head, paddle.Parameter)
    # one entry, under the name met first (the layer's own, as in JAX)
    assert list(m.state_dict()) == ["head"]


# ------------------------------------------------------- initializers ----

@pytest.mark.parametrize("init,shape", [
    (lambda I: I.Constant(0.25), [3, 4]),
    (lambda I: I.Assign(np.arange(12, dtype=np.float32).reshape(3, 4)),
     [3, 4]),
    (lambda I: I.Dirac(), [4, 4, 3, 3]),
], ids=["Constant", "Assign", "Dirac"])
def test_deterministic_initializers_match_jax(init, shape):
    got = paddle.create_parameter(shape, "float32",
                                  default_initializer=init(nn.initializer))
    want = jp.create_parameter(shape, "float32",
                               default_initializer=init(jnn.initializer))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name,make,law", [
    ("Normal", lambda I: I.Normal(0.5, 0.1), ("normal", 0.5, 0.1)),
    ("TruncatedNormal", lambda I: I.TruncatedNormal(0.0, 0.2),
     ("trunc", 0.0, 0.2)),
    ("Uniform", lambda I: I.Uniform(-0.3, 0.3), ("uniform", -0.3, 0.3)),
    ("XavierNormal", lambda I: I.XavierNormal(),
     ("normal", 0.0, math.sqrt(2.0 / (256 + 384)))),
    ("XavierUniform", lambda I: I.XavierUniform(),
     ("uniform_lim", math.sqrt(6.0 / (256 + 384)))),
    ("KaimingNormal", lambda I: I.KaimingNormal(),
     ("normal", 0.0, math.sqrt(2.0) / math.sqrt(256))),
    ("KaimingUniform", lambda I: I.KaimingUniform(),
     ("uniform_lim", math.sqrt(2.0) * math.sqrt(3.0 / 256))),
])
def test_random_initializers_follow_their_fan_and_gain(name, make, law):
    paddle.seed(1)
    p = paddle.create_parameter([256, 384], "float32",
                                default_initializer=make(nn.initializer))
    jv = jp.create_parameter([256, 384], "float32",
                             default_initializer=make(jnn.initializer))
    for v in (p.numpy(), jv.numpy()):
        kind = law[0]
        if kind == "normal":
            assert abs(v.mean() - law[1]) < 0.01 * max(law[2], 0.1)
            assert abs(v.std() / law[2] - 1) < 0.02, name
        elif kind == "trunc":
            assert np.abs(v).max() <= 2 * law[2] + 1e-6
            assert abs(v.std() / (law[2] * 0.8796) - 1) < 0.03, name
        elif kind == "uniform":
            assert v.min() >= law[1] and v.max() <= law[2]
            assert abs(v.std() / ((law[2] - law[1]) / math.sqrt(12)) - 1) \
                < 0.02
        else:
            assert np.abs(v).max() <= law[1] + 1e-6
            assert abs(v.std() / (law[1] / math.sqrt(3)) - 1) < 0.02, name
    assert nn.initializer.calculate_gain("leaky_relu", 0.1) == \
        jnn.initializer.calculate_gain("leaky_relu", 0.1)


def test_orthogonal_initializer():
    # the JAX package's Orthogonal draws a batch of square matrices and
    # cannot reshape it to a 2-d weight (ROADMAP.md C): the port's alone
    p = paddle.create_parameter([256, 384], "float32",
                                default_initializer=nn.initializer.Orthogonal(
                                    gain=2.0))
    v = p.numpy()
    np.testing.assert_allclose(v @ v.T, 4.0 * np.eye(256), atol=1e-4)
    # the JAX package fails after it dispatched its QR of the whole batch,
    # which then runs on unawaited and holds up the worker's next JAX call
    # (at [256, 384], 384 QRs of 256 x 256: 741 s of the next test in a
    # loaded xdist run); it draws prod(shape[1:]) matrices of shape[0] x
    # shape[0], which reshape to no weight of more than one row, so the
    # refusal is the same at any such shape
    with pytest.raises(TypeError):
        jp.create_parameter([4, 6], "float32",
                            default_initializer=jnn.initializer.Orthogonal())


def test_param_attr_on_create_parameter_and_linear():
    attr = nn.ParamAttr(name="w", initializer=nn.initializer.Constant(2.0),
                        learning_rate=0.5, trainable=False)
    p = paddle.create_parameter([2, 3], "float32", attr=attr)
    assert p.name == "w" and p.stop_gradient
    assert p.optimize_attr["learning_rate"] == 0.5
    assert float(p.sum()) == 12.0
    lin = nn.Linear(2, 3, weight_attr=nn.initializer.Constant(1.0),
                    bias_attr=False)
    assert lin.bias is None and float(lin.weight.sum()) == 6.0


# ------------------------------------------- state dicts and checkpoints ----

def test_gpt_state_dict_names_and_order_match_jax():
    jm, tm = gpt_pair(layers=2, hidden=32, heads=2, vocab=31, max_pos=16)
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in tm.named_sublayers()] == [
        n for n, _ in jm.named_sublayers()][:len(list(tm.named_sublayers()))]


def _gpt_models():
    from paddle_tpu.models import GPTConfig, GPTForCausalLM

    import paddle_tpu_torch.models as pm

    kw = dict(vocab_size=31, hidden_size=32, num_layers=2, num_heads=2,
              max_position_embeddings=16, hidden_dropout=0.0,
              attention_dropout=0.0, initializer_range=0.3)
    with unique_name.guard():
        jp.seed(4)
        jm = GPTForCausalLM(GPTConfig(**kw))
    tm = pm.GPTForCausalLM(pm.GPTConfig(**kw), device="cpu")
    return jm.eval(), tm.eval()


def _resnet_models():
    from paddle_tpu.vision import models as JM

    from paddle_tpu_torch.vision import models as PM

    with unique_name.guard():
        jp.seed(5)
        jm = JM.resnet18(num_classes=10)
    # running statistics that are not the init's: a train-mode forward
    jm.train()
    jm(jp.to_tensor(np.random.RandomState(6).randn(4, 3, 32, 32).astype(
        np.float32) * 2 + 0.5))
    tm = PM.resnet18(num_classes=10, device="cpu")
    return jm.eval(), tm.eval()


@pytest.mark.parametrize("which", ["gpt", "resnet"])
def test_pdparams_carry_across_the_packages_both_ways(which, tmp_path):
    if which == "gpt":
        jm, tm = _gpt_models()
        x = np.random.RandomState(7).randint(0, 31, (2, 12))
        jx, tx = jp.to_tensor(x), paddle.to_tensor(x)
    else:
        jm, tm = _resnet_models()
        x = np.random.RandomState(7).randn(2, 3, 32, 32).astype(np.float32)
        jx, tx = jp.to_tensor(x), paddle.to_tensor(x)
    # JAX -> port
    path = str(tmp_path / "jax.pdparams")
    jp.save(jm.state_dict(), path)
    missing, unexpected = tm.set_state_dict(paddle.load(path))
    assert missing == [] and unexpected == []
    want = jm(jx).numpy()
    got = tm(tx)
    assert isinstance(got, paddle.Tensor)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # port -> JAX, into a fresh JAX model
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(0.9)
        if which == "resnet":
            tm.bn1._mean.add_(0.1)
    path2 = str(tmp_path / "port.pdparams")
    paddle.save(tm.state_dict(), path2)
    jm2 = _gpt_models()[0] if which == "gpt" else _resnet_models()[0]
    jm2.set_state_dict(jp.load(path2))
    np.testing.assert_allclose(tm(tx).numpy(), jm2(jx).numpy(), atol=1e-5,
                               rtol=1e-5)


def test_bf16_saves_as_fp32_and_loads_back(tmp_path):
    lin = nn.Linear(3, 2)
    lin.to(dtype="bfloat16")
    path = str(tmp_path / "bf16.pdparams")
    paddle.save(lin.state_dict(), path)
    arrays = paddle.load(path, return_numpy=True)
    assert arrays["weight"].dtype == np.float32
    lin2 = nn.Linear(3, 2)
    lin2.to(dtype="bfloat16")
    lin2.set_state_dict(paddle.load(path))
    assert lin2.weight.dtype == torch.bfloat16
    assert torch.equal(lin2.weight, lin.weight)


def test_load_of_a_truncated_file_raises(tmp_path):
    path = tmp_path / "bad.pdparams"
    paddle.save({"a": paddle.ones([4])}, str(path))
    path.write_bytes(path.read_bytes()[:10])
    with pytest.raises(paddle.framework.CheckpointCorruptError):
        paddle.load(str(path))
