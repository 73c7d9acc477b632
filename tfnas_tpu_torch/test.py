"""Score a trained TF-NAS model on a validation set (counterpart of the
repository's test.py).

    python -m tfnas_tpu_torch.test --weights checkpoint.pkl \
        --val_root ... --val_list ... [--config_path model.config]

--weights is an eval checkpoint written by either package's retrain
driver; the architecture comes from --model_path, --config_path or the
checkpoint's own model_config. f32 compute (`--device`, default cuda).
Under torchrun (`--nproc_per_node N`) each process scores its host shard
of the list (or its rows of each --synthetic batch) at batch_size / N and
the sums are added over the ranks; only rank 0 prints. The final batch is
padded and masked, so loss, top-1 and top-5 are exact over the full set.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from .convert import eval_state_from_jax
from .data import (DataLoader, ImageList, device_normalizer, image_decoder,
                   synthetic_loader)
from .device import resolve_device
from .models.eval_net import EvalNetwork
from .parallel.mesh import (host_shard, is_main_process, local_device,
                            make_mesh, maybe_distributed_init)
from .parallel.train_dp import make_eval_steps
from .search.parser import (get_mc_num_dddict, get_op_and_depth_weights,
                            parse_architecture)
from .train_eval import local_batch, validate
from .utils import load_checkpoint

parser = argparse.ArgumentParser("testing the trained architectures "
                                 "(PyTorch)")
parser.add_argument('--val_root', type=str, default='')
parser.add_argument('--val_list', type=str, default='')
parser.add_argument('--model_path', type=str, default='',
                    help='the searched model path')
parser.add_argument('--config_path', type=str, default='',
                    help='the model config path')
parser.add_argument('--weights', type=str, required=True,
                    help='pretrained model weights (eval checkpoint)')
parser.add_argument('--workers', type=int, default=4)
parser.add_argument('--batch_size', type=int, default=512)
parser.add_argument('--num_classes', type=int, default=1000)
parser.add_argument('--synthetic', action='store_true')
parser.add_argument('--image_size', type=int, default=224)
parser.add_argument('--device', type=str, default='cuda')


def build_net(args, ckpt):
    if args.model_path and os.path.isfile(args.model_path):
        op_w, depth_w = get_op_and_depth_weights(args.model_path)
        mc_mask = load_checkpoint(args.model_path)['mc_mask_dddict']
        return EvalNetwork.from_parsed_arch(
            args.num_classes, parse_architecture(op_w, depth_w),
            get_mc_num_dddict(mc_mask))
    if args.config_path and os.path.isfile(args.config_path):
        with open(args.config_path) as f:
            return EvalNetwork.from_config(args.num_classes, json.load(f))
    if 'model_config' in ckpt:
        return EvalNetwork.from_config(args.num_classes, ckpt['model_config'])
    raise SystemExit('invalid --model_path and --config_path')


def main(argv=None):
    args = parser.parse_args(argv)
    device = local_device(resolve_device(args.device))
    _, world = maybe_distributed_init(device)
    show = print if is_main_process() else (lambda *a: None)
    show('parsing the architecture')
    ckpt = load_checkpoint(args.weights)
    net = build_net(args, ckpt)
    state = eval_state_from_jax(ckpt, device)
    # f32: test.py is the accuracy scorer; bf16 is the training default
    _, val_step = make_eval_steps(net, num_classes=args.num_classes,
                                  compute_dtype=torch.float32,
                                  group=make_mesh(world).data_group)
    if args.synthetic:
        batches = synthetic_loader(args.batch_size, 8, args.num_classes,
                                   args.image_size, shard=host_shard())
    else:
        ds = ImageList(args.val_root, args.val_list, training=False,
                       image_size=args.image_size, host_shard=host_shard(),
                       device=device)
        show('image decode: {}'.format(image_decoder(device)))
        batches = DataLoader(ds, local_batch(args.batch_size), shuffle=False,
                             num_workers=args.workers, drop_last=False,
                             pad_last=True)
    loss, top1, top5 = validate(val_step, state, batches,
                                device_normalizer(torch.float32), device)
    show('Val_loss: {:.6f}'.format(loss))
    show('Val_acc_top1: {:.4f}'.format(top1))
    show('Val_acc_top5: {:.4f}'.format(top5))
    return {"loss": float(loss), "top1": float(top1), "top5": float(top5)}


if __name__ == '__main__':
    main()
