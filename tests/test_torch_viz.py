"""The port's ``mx.viz`` against the JAX package's, on the CPU:
``print_summary``'s table is equal character for character for the MLP,
LeNet and a ResNet block, with shapes and without, and
``plot_network(...).source`` is equal (with weights hidden and shown)."""
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _mlp(mx):
    return mx.models.get_mlp()


def _lenet(mx):
    return mx.models.get_lenet()


def _resnet_block(mx):
    data = mx.sym.Variable("data")
    c1 = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="conv1")
    b1 = mx.sym.BatchNorm(c1, name="bn1")
    a1 = mx.sym.Activation(b1, act_type="relu", name="relu1")
    c2 = mx.sym.Convolution(a1, num_filter=8, kernel=(3, 3), pad=(1, 1),
                            name="conv2")
    b2 = mx.sym.BatchNorm(c2, name="bn2")
    out = mx.sym.Activation(b2 + data, act_type="relu", name="relu2")
    net = mx.sym.FullyConnected(mx.sym.Flatten(out), num_hidden=10,
                                name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


NETS = {"mlp": (_mlp, {"data": (4, 784), "softmax_label": (4,)}),
        "lenet": (_lenet, {"data": (2, 1, 28, 28), "softmax_label": (2,)}),
        "resnet-block": (_resnet_block, {"data": (2, 8, 6, 6),
                                         "softmax_label": (2,)})}


def _build(mx, name):
    import mxnet_tpu.models  # noqa: F401  (not imported by the package)
    with mx.name.NameManager():
        return NETS[name][0](mx)


@pytest.mark.parametrize("with_shape", [True, False])
@pytest.mark.parametrize("name", sorted(NETS))
def test_print_summary_equals_jax(name, with_shape, capsys):
    shape = NETS[name][1] if with_shape else None
    jmx.viz.print_summary(_build(jmx, name), shape=shape)
    want = capsys.readouterr().out
    tmx.viz.print_summary(_build(tmx, name), shape=shape)
    got = capsys.readouterr().out
    assert got == want
    assert "Total params" in got


@pytest.mark.parametrize("hide", [True, False])
@pytest.mark.parametrize("name", sorted(NETS))
def test_plot_network_source_equals_jax(name, hide):
    pytest.importorskip("graphviz")
    want = jmx.viz.plot_network(_build(jmx, name), title=name,
                                hide_weights=hide).source
    got = tmx.viz.plot_network(_build(tmx, name), title=name,
                               hide_weights=hide).source
    assert got == want


def test_visualization_print_summary(capsys):
    data = tmx.sym.Variable("data")
    net = tmx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = tmx.sym.Activation(net, act_type="relu", name="relu1")
    net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(net, num_hidden=2,
                                                       name="fc2"),
                                name="softmax")
    tmx.viz.print_summary(net, shape={"data": (4, 16),
                                      "softmax_label": (4,)})
    out = capsys.readouterr().out
    assert "fc1" in out and "fc2" in out
    # total params: 16*8+8 + 8*2+2 = 154
    assert "154" in out, out
