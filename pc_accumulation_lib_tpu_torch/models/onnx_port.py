"""ONNX weights into the port's ResNet50DilatedFCN.

Counterpart of models/onnx_port.py. The reference semseg checkpoint
(``semseg_rn50_160k_cm.onnx``) is an mmsegmentation FCN head on a dilated
ResNet-50 v1c backbone; its initializers carry the mmseg state-dict names,
which are the port's own module names, so no name map or layout transpose
is needed (torch convs are OIHW, as ONNX stores them).

Matching is BY NAME first (exact, or a unique suffix when an exporter
prefixed the names: models/semseg.load_named_tensors); shape agreement is
an assertion, never the matching key, because a batch norm's four tensors
share one shape. When an exporter renamed every initializer
(``onnx::Conv_123``, ``p_backbone_...``), the structural matcher recovers
each tensor's role from the graph's dataflow. A graph that is neither
fails with both reasons.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def structural_torch_names(named: Dict[str, np.ndarray],
                           nodes) -> Dict[str, str]:
    """Recover the mmseg/torch state-dict names of a ResNet bottleneck FCN
    graph's initializers from DATAFLOW alone.

    The walker follows the activation dataflow: the stem conv-bn-relu
    chain up to the MaxPool, then bottleneck blocks (a block with a
    downsample conv starts a new stage, as in ResNet), then the FCN head
    conv-bn-relu and the biased classifier conv. Within a block the two
    convs that read the block input are told apart by out-channels (conv1
    reduces to C_mid, the downsample expands to 4*C_mid), never by name or
    node order.

    Args:
      named: {initializer name: ndarray} (values used only for shapes).
      nodes: [(op_type, inputs, outputs)] in topological (file) order, as
        ``onnx_pb.read_graph`` returns them.

    Returns {initializer name: state-dict name} for every weight the model
    holds (preprocessing constants and the like are left out). Raises
    ValueError naming the failing tensor when the graph does not parse as
    this architecture (e.g. batch norms folded into the convs: such an
    export cannot be loaded and must fail loudly).
    """
    consumers: Dict[str, list] = {}
    for n in nodes:
        for t in n[1]:
            consumers.setdefault(t, []).append(n)

    def data_consumers(t, op):
        # Nodes of type op reading activation t through a data input
        # (input 0; either of the first two for Add), not as a weight.
        k = 2 if op == 'Add' else 1
        return [n for n in consumers.get(t, ())
                if n[0] == op and t in n[1][:k]]

    def step(t, op):
        hits = data_consumers(t, op)
        if len(hits) != 1:
            raise ValueError(
                f'structural port: expected exactly one {op} consumer of '
                f'{t!r}, found {len(hits)} — graph is not a plain ResNet '
                'bottleneck FCN')
        return hits[0]

    names: Dict[str, str] = {}

    def name_conv(conv, base):
        if len(conv[1]) < 2:
            raise ValueError(f'structural port: Conv for {base} has no '
                             'weight input')
        names[conv[1][1]] = f'{base}.weight'
        if len(conv[1]) > 2:
            names[conv[1][2]] = f'{base}.bias'

    def name_bn(bn, base):
        if len(bn[1]) < 5:
            raise ValueError(f'structural port: BatchNormalization for '
                             f'{base} is missing scale/bias/mean/var')
        for tensor, leaf in zip(bn[1][1:5], ('weight', 'bias',
                                             'running_mean',
                                             'running_var')):
            names[tensor] = f'{base}.{leaf}'

    def conv_bn(t, conv_base, bn_base):
        conv = step(t, 'Conv')
        bn = step(conv[2][0], 'BatchNormalization')
        name_conv(conv, conv_base)
        name_bn(bn, bn_base)
        return bn[2][0]

    # Stem: the first Conv in topological order anchors the walk (what
    # comes before it is preprocessing: Sub/Div/Resize, no convs).
    first_conv = next((n for n in nodes if n[0] == 'Conv'), None)
    if first_conv is None:
        raise ValueError('structural port: graph contains no Conv nodes')
    t = first_conv[1][0]
    i = 1
    while True:
        bout = conv_bn(t, f'backbone.stem.{3 * (i - 1)}',
                       f'backbone.stem.{3 * (i - 1) + 1}')
        t = step(bout, 'Relu')[2][0]
        pools = data_consumers(t, 'MaxPool')
        if pools:
            t = pools[0][2][0]
            break
        i += 1
        if i > 4:
            raise ValueError('structural port: no MaxPool after 4 stem '
                             'conv-bn-relu links — not a ResNet stem')

    # Bottleneck stages; the head ends the loop.
    stage = block = 0
    while True:
        cs = data_consumers(t, 'Conv')
        if len(cs) == 1:
            # A bottleneck without downsample, or the FCN head: look for
            # the bottleneck's Add before naming anything.
            try:
                c1 = cs[0]
                b1 = step(c1[2][0], 'BatchNormalization')
                r1 = step(b1[2][0], 'Relu')
                c2 = step(r1[2][0], 'Conv')
                b2 = step(c2[2][0], 'BatchNormalization')
                r2 = step(b2[2][0], 'Relu')
                c3 = step(r2[2][0], 'Conv')
                b3 = step(c3[2][0], 'BatchNormalization')
                add = step(b3[2][0], 'Add')
            except ValueError:
                break                        # the head, parsed below
            if t not in add[1][:2]:
                raise ValueError(
                    'structural port: bottleneck Add does not consume the '
                    'block input as identity')
            block += 1
            prefix = f'backbone.layer{stage}.{block - 1}'
            for c, b, k in ((c1, b1, 1), (c2, b2, 2), (c3, b3, 3)):
                name_conv(c, f'{prefix}.conv{k}')
                name_bn(b, f'{prefix}.bn{k}')
            t = step(add[2][0], 'Relu')[2][0]
            continue
        if len(cs) != 2:
            raise ValueError(
                f'structural port: activation {t!r} feeds {len(cs)} convs '
                '(expected 1-2; auxiliary heads are not supported)')
        wa = named.get(cs[0][1][1])
        wb = named.get(cs[1][1][1])
        if wa is None or wb is None or wa.shape[0] == wb.shape[0]:
            raise ValueError(
                'structural port: cannot tell conv1 from the downsample '
                'conv (missing weights or equal out-channels)')
        conv1, down = ((cs[0], cs[1]) if wa.shape[0] < wb.shape[0]
                       else (cs[1], cs[0]))
        stage += 1
        block = 1
        prefix = f'backbone.layer{stage}.0'
        bout = step(conv1[2][0], 'BatchNormalization')
        name_conv(conv1, f'{prefix}.conv1')
        name_bn(bout, f'{prefix}.bn1')
        cur = step(bout[2][0], 'Relu')[2][0]
        for k in (2, 3):
            conv = step(cur, 'Conv')
            bn = step(conv[2][0], 'BatchNormalization')
            name_conv(conv, f'{prefix}.conv{k}')
            name_bn(bn, f'{prefix}.bn{k}')
            cur = step(bn[2][0], 'Relu')[2][0] if k == 2 else bn[2][0]
        dbn = step(down[2][0], 'BatchNormalization')
        name_conv(down, f'{prefix}.downsample.0')
        name_bn(dbn, f'{prefix}.downsample.1')
        add = step(cur, 'Add')
        if dbn[2][0] not in add[1][:2]:
            raise ValueError(
                'structural port: downsample output is not the Add '
                'identity input')
        t = step(add[2][0], 'Relu')[2][0]

    if stage == 0:
        raise ValueError('structural port: found no bottleneck stages')
    # FCN head: conv-bn-relu, then the biased classifier conv.
    bout = conv_bn(t, 'decode_head.convs.0.conv', 'decode_head.convs.0.bn')
    t = step(bout, 'Relu')[2][0]
    name_conv(step(t, 'Conv'), 'decode_head.conv_seg')
    return names


def load_onnx_weights(path: str, model) -> None:
    """Load an .onnx file's weights into ``model`` (a ResNet50DilatedFCN,
    or the SemSegTorch holding one), in place.

    The file is read with the port's own ModelProto reader
    (models/onnx_pb.py). Matching is by state-dict name (exact or unique
    suffix; initializers the model does not hold, such as preprocessing
    constants, are ignored); if that fails, by the graph's dataflow
    (``structural_torch_names``). Raises ValueError carrying both reasons
    when neither matches, and ValueError for a truncated or corrupt file.
    The model is changed only when every tensor was found."""
    from pc_accumulation_lib_tpu_torch.models import onnx_pb
    from pc_accumulation_lib_tpu_torch.models.semseg import (
        load_named_tensors)
    named, nodes = onnx_pb.read_graph(path)
    try:
        load_named_tensors(model, named, ignore_unused=True)
        return
    except (KeyError, ValueError) as err:
        name_err = err
    try:
        mapping = structural_torch_names(named, nodes)
        load_named_tensors(model, {tn: named[src]
                                   for src, tn in mapping.items()})
    except (KeyError, ValueError) as struct_err:
        raise ValueError(
            f'ONNX port failed by name ({name_err}) and by structure '
            f'({struct_err})') from struct_err


def export_named_tensors(model) -> Dict[str, np.ndarray]:
    """The inverse of models/semseg.load_named_tensors: a SemSegTorch's
    (or a ResNet50DilatedFCN's) weights and batch-norm running statistics
    as {mmsegmentation name: OIHW / 1-D numpy array}, the names the JAX
    package's onnx_port.convert_named_tensors reads; batch-norm step
    counters, which it has no place for, are left out. A model cut by
    models/train.shard_variables is gathered to full tensors first, so
    every rank of its model axis calls this."""
    from pc_accumulation_lib_tpu_torch.models.train import gather_named
    module = getattr(model, 'model', model)
    state = gather_named(module, module.state_dict())
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if not k.endswith('num_batches_tracked')}
