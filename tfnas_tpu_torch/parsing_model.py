"""Parse a searched checkpoint into a model.config (counterpart of the
repository's parsing_model.py).

    python -m tfnas_tpu_torch.parsing_model --model_path searched_model_NN.pkl \
        --save_path model.config [--space hybrid | --space tiny
        --image_size 32] [--print_lat]

Argmax of the ops and depths of the checkpoint's arch parameters, widths
from its masks; writes the model.config JSON and prints Params and FLOPs,
and with --print_lat the LUT latency and the latency of the BN-folded bf16
network measured on the device (cost/measure.py) at batch 32 and batch 1.
"""

from __future__ import annotations

import argparse
import json

import torch

from .cost import (build_space_analytic_lut, calculate_FLOPs_in_M,
                   count_parameters_in_MB, load_lat_lookup)
from .cost.measure import measure_model_latency_in_ms
from .device import resolve_device
from .models import search_space as ss
from .models.eval_net import EvalNetwork
from .search.parser import (get_mc_num_dddict, get_op_and_depth_weights,
                            parse_architecture)
from .utils import load_checkpoint

parser = argparse.ArgumentParser("parsing TF-NAS (PyTorch)")
parser.add_argument('--model_path', type=str, required=True,
                    help='path of searched model checkpoint')
parser.add_argument('--save_path', type=str, default='./model.config',
                    help='saving path of parsed architecture config')
parser.add_argument('--lookup_path', type=str,
                    default='./latency_pkl/latency_tpu.pkl',
                    help='path of latency lookup')
parser.add_argument('--print_lat', action='store_true',
                    help='measure and print the latency')
parser.add_argument('--num_classes', type=int, default=1000)
parser.add_argument('--space', type=str, default='mbconv',
                    choices=['mbconv', 'hybrid', 'tiny'])
parser.add_argument('--image_size', type=int, default=224,
                    help='input resolution for the FLOPs report')
parser.add_argument('--device', type=str, default='cuda')


def print_latency(model, lat_lookup, image_size, device):
    """The LUT latency of `model`, then its BN-folded bf16 forward timed on
    `device` at batch 32 and batch 1 (the JAX driver prints these as
    Lat_TPU; here the device's kind names them)."""
    print('Lat_LUT:\t{:.4f}ms'.format(model.get_lookup_latency(
        lat_lookup, input_size=image_size)))
    kind = "GPU" if device.type == "cuda" else device.type.upper()
    out = {}
    for bs in (32, 1):
        out[bs] = measure_model_latency_in_ms(model, bs, image_size,
                                              torch.bfloat16, device=device)
        print('Lat_{} bs={}:\t{:.4f}ms'.format(kind, bs, out[bs]))
    return out


def main(argv=None):
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    # hybrid shares the reference skeleton: from_parsed_arch builds the ViT
    # candidate from op index 8 of the parsed arch
    space = ss.tiny_space(args.image_size) if args.space == 'tiny' else None

    op_weights, depth_weights = get_op_and_depth_weights(args.model_path)
    parsed_arch = parse_architecture(op_weights, depth_weights, space=space)
    mc_mask_dddict = load_checkpoint(args.model_path)['mc_mask_dddict']
    model = EvalNetwork.from_parsed_arch(
        args.num_classes, parsed_arch, get_mc_num_dddict(mc_mask_dddict),
        space=space)

    with open(args.save_path, 'w') as f:
        json.dump(model.config, f, indent=4)

    params, _ = model.init(torch.Generator(device=device).manual_seed(0))
    print('Params:  \t{:.4f}MB'.format(count_parameters_in_MB(params)))
    print('FLOPs:  \t{:.4f}M'.format(
        calculate_FLOPs_in_M(model, args.image_size)))

    if args.print_lat:
        lat_lookup = (build_space_analytic_lut(space) if space is not None
                      else load_lat_lookup(args.lookup_path))
        print_latency(model, lat_lookup, args.image_size, device)
    return model


if __name__ == '__main__':
    main()
