"""The port's export tool (`cli/export.py`) against the JAX package's: the
parameters per top module equal to JAX's `summarize`, the FlopCounterMode
count equal to an analytic count of the convolutions and the heads'
matmul, `--to-torch` key for key and bit for bit the JAX package's
`save_torch_checkpoint` of the same weights, and the `torch.export`
program of forward + decode (tiny width, CPU) saved, loaded in a fresh
process and run: bit-equal to the eager port, within 1e-4 of JAX's
`_decode_body` (counts equal), with the decode's custom ops
(`offsetguided::peaks_topk`, `::group_skeletons`) in its graph; and each
of the four custom ops through `torch.library.opcheck`."""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offsetguided_tpu.cli import export as jexport
from offsetguided_tpu.config.defaults import DecoderConfig as JDecoderConfig
from offsetguided_tpu.config.defaults import ModelConfig as JModelConfig
from offsetguided_tpu.decoder import PostProcessor as JPostProcessor
from offsetguided_tpu.models import PoseNet as JPoseNet
from offsetguided_tpu.models import checkpoint as jckpt
from offsetguided_tpu_torch.cli import export
from offsetguided_tpu_torch.config.defaults import DecoderConfig
from offsetguided_tpu_torch.decoder import PostProcessor
from offsetguided_tpu_torch.ops.image import normalize_images

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_serve import tamed_variables  # noqa: E402

# the suite's worker processes share the host's cores
torch.set_num_threads(2)

TINY = ['--debug-tiny-model', '--device', 'cpu']
# a narrow 2-stack, 3-level variant through the width flags
NARROW = ['--hg-order', '3', '--dims', '8,8,12,16', '--modules', '1,1,1,2',
          '--cnv-dim', '8', '--n-stacks', '2', '--device', 'cpu']
SIZE = 64


def jax_config(argv):
    """The JAX export tool's ModelConfig for the same flags."""
    args = jexport.cli([a for a in argv if a not in ('--device', 'cpu')])
    if args.debug_tiny_model:
        return JModelConfig(basenet=args.basenet, n_stacks=1, hg_order=2,
                            dims=(8, 8, 12), modules=(1, 1, 1), cnv_dim=8,
                            compute_dtype='float32')
    return JModelConfig(hg_order=args.hg_order,
                        dims=tuple(int(d) for d in args.dims.split(',')),
                        modules=tuple(int(m) for m in args.modules.split(',')),
                        cnv_dim=args.cnv_dim, n_stacks=args.n_stacks)


@pytest.mark.parametrize('argv', [TINY, NARROW], ids=['tiny', 'narrow'])
def test_summarize_matches_jax(argv):
    jcfg = jax_config(argv)
    shapes = jax.eval_shape(lambda: JPoseNet(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))
    theirs = jexport.summarize(shapes)
    ours = export.summarize(export.build_model(export.cli(argv), 'cpu'))
    assert list(ours.values()) == list(theirs.values())
    assert list(ours) == ['basenet', 'headnets', 'TOTAL']


@pytest.mark.parametrize('argv', [TINY, NARROW], ids=['tiny', 'narrow'])
def test_flop_count_is_the_analytic_count(argv):
    """2 * multiply-adds of every backbone convolution (from its output
    shape) plus the fused 1x1 heads' matmul per stack."""
    model = export.build_model(export.cli(argv), 'cpu').prepare_inference()
    x = torch.zeros((2, SIZE, SIZE, 3))
    want = []

    def hook(m, inp, out):
        want.append(2 * out.numel() * m.in_channels // m.groups
                    * m.kernel_size[0] * m.kernel_size[1])

    handles = [m.register_forward_hook(hook)
               for m in model.basenet.modules()
               if isinstance(m, torch.nn.Conv2d)]
    got = export.count_flops(model, x)
    for h in handles:
        h.remove()
    heads = [c for c in model.headnets.modules()
             if isinstance(c, torch.nn.Conv2d)]
    cin = heads[0].in_channels
    n_stacks = model.cfg.n_stacks
    ctot = sum(c.out_channels for c in heads) // n_stacks
    head_flops = n_stacks * 2 * 2 * (SIZE // 4) ** 2 * cin * ctot
    assert want and got == sum(want) + head_flops


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """Tamed tiny JAX variables and their reference `.pth` written by the
    JAX package."""
    jcfg = jax_config(TINY)
    variables = tamed_variables(jcfg)
    path = str(tmp_path_factory.mktemp('w') / 'jax.pth')
    jckpt.save_torch_checkpoint(path, variables, jcfg)
    return variables, jcfg, path


def test_to_torch_equals_jax_save_torch_checkpoint(weights, tmp_path):
    _, _, jax_pth = weights
    out = str(tmp_path / 'port.pth')
    export.main(TINY + ['--torch-checkpoint', jax_pth, '--to-torch', out,
                        '--input-size', str(SIZE)])
    a = torch.load(out, weights_only=False)
    b = torch.load(jax_pth, weights_only=False)
    assert a.keys() == b.keys() == {'epoch', 'train_loss',
                                    'model_state_dict'}
    assert a['epoch'] == b['epoch'] and np.isnan(a['train_loss']) \
        and np.isnan(b['train_loss'])
    sa, sb = a['model_state_dict'], b['model_state_dict']
    assert list(sa) == list(sb)
    for k in sb:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def test_to_torch_refuses_other_backbones(tmp_path):
    """As the JAX package does: the reference names exist for
    Hourglass-104 only (checked before the weights are read)."""
    args = export.cli(['--basenet', 'hourglass4stage'])
    model = types.SimpleNamespace(cfg=export.model_config(args))
    with pytest.raises(ValueError, match='Hourglass-104'):
        export.save_reference_checkpoint(str(tmp_path / 'x.pth'), model)
    assert not (tmp_path / 'x.pth').exists()


@pytest.fixture(scope='module')
def exported(weights, tmp_path_factory):
    """The tiny model's forward + decode exported at (2, 64, 64, 3), the
    seeded normalized input, and the eager outputs."""
    _, _, pth = weights
    path = str(tmp_path_factory.mktemp('pt2') / 'tiny.pt2')
    r = export.main(TINY + ['--torch-checkpoint', pth, '--with-decode',
                            '--output', path, '--input-size', str(SIZE),
                            '--batch-size', '2'])
    rng = np.random.RandomState(3)
    images = normalize_images(torch.from_numpy(
        rng.randint(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)))
    model = export.build_model(export.cli(
        TINY + ['--torch-checkpoint', pth]), 'cpu').prepare_inference()
    with torch.inference_mode():
        eager = export.Forward(model, PostProcessor(cfg=DecoderConfig()))(
            images)
    return r, path, images, eager


def test_program_holds_the_custom_ops(exported):
    r = exported[0]
    targets = {str(n.target) for n in r['program'].graph.nodes
               if n.op == 'call_function'}
    assert {'offsetguided.peaks_topk.default',
            'offsetguided.group_skeletons.default'} <= targets
    assert r['export_s'] > 0


LOAD = '''
import sys, numpy as np, torch
import offsetguided_tpu_torch.ops.cuda
program = torch.export.load(sys.argv[1]).module()
images = torch.from_numpy(np.load(sys.argv[2]))
out = program(images)
np.savez(sys.argv[3], *[t.numpy() for t in out])
'''


def test_program_in_a_fresh_process_equals_eager(exported, tmp_path):
    _, path, images, eager = exported
    np.save(tmp_path / 'x.npy', images.numpy())
    subprocess.run([sys.executable, '-c', LOAD, path, str(tmp_path / 'x.npy'),
                    str(tmp_path / 'out.npz')], check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
    got = np.load(tmp_path / 'out.npz')
    for i, want in enumerate(eager):
        np.testing.assert_array_equal(got[f'arr_{i}'], want.numpy())
    assert int(eager[2].sum()) > 0


def test_program_matches_jax_decode_body(exported, weights):
    """The loaded program against JAX's forward + `_decode_body`: poses
    within 1e-4 px, counts equal."""
    _, path, images, _ = exported
    variables, jcfg, _ = weights
    program = torch.export.load(path).module()
    poses, scores, counts = program(images)
    pp = JPostProcessor(cfg=JDecoderConfig())
    jp, js, jc = jax.jit(lambda v, x: pp._decode_body(
        JPoseNet(jcfg).apply(v, x, train=False), False))(
        variables, jnp.asarray(images.numpy()))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_allclose(poses.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=0,
                               atol=1e-4)


def test_forward_program_equals_eager(weights):
    _, _, pth = weights
    model = export.build_model(export.cli(
        TINY + ['--torch-checkpoint', pth]), 'cpu').prepare_inference()
    x = normalize_images(torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)))
    got = export.export_program(model, x).module()(x)
    with torch.inference_mode():
        want = model(x)
    assert got.keys() == want.keys()
    for k, stacks in want.items():
        for a, b in zip(got[k], stacks):
            assert (a is None) == (b is None), k
            if b is not None:
                assert torch.equal(a, b), k


def test_export_cli_flags_match_jax():
    theirs = vars(jexport.cli([]))
    ours = vars(export.cli([]))
    assert ours.pop('device') is None
    assert ours == theirs


def op_cases():
    rng = np.random.RandomState(0)
    maps = torch.from_numpy(rng.rand(6, 12, 12).astype(np.float32))
    flat = torch.from_numpy(rng.rand(6, 100).astype(np.float32))
    limbs = torch.from_numpy(rng.rand(2, 19, 8, 13).astype(np.float32) * 50)
    cfg = DecoderConfig()
    sk = [j for pair in PostProcessor().skeleton.skeleton for j in pair]
    ops = torch.ops.offsetguided
    return {'peaks_topk': (ops.peaks_topk.default, (maps, 8, 'bicubic')),
            'topk': (ops.topk.default, (flat, 8)),
            'nms_topk': (ops.nms_topk.default, (maps, 8)),
            'group_skeletons': (ops.group_skeletons.default,
                                (limbs, sk, 17, cfg.capacity, cfg.max_poses,
                                 cfg.settle_passes, cfg.sort_dim,
                                 cfg.use_scale, cfg.dist_max,
                                 cfg.person_thre))}


@pytest.mark.parametrize('name', ['peaks_topk', 'topk', 'nms_topk',
                                  'group_skeletons'])
def test_custom_op_passes_opcheck(name):
    """`torch.library.opcheck` on the CPU implementation: the schema, the
    fake implementation's shapes, dtypes and strides, and no output
    aliasing an input."""
    op, args = op_cases()[name]
    torch.library.opcheck(op, args)
