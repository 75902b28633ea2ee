"""Correspondence evaluation CLI (port of pose6d_tpu/cli/eval.py; the
reference's scripts/eval.py).

    python -m pose6d_tpu_torch.cli.eval --config config/lm_synth.yaml \
        --weights <logdir>/params_latest.msgpack --save-results [--device cpu]

--weights is a flax msgpack params file (either package writes one) or
the reference's torch checkpoint weights.pt (read with torch.load,
tensors only, and mapped by models/port_weights.py).
"""
from __future__ import annotations

from ._common import add_multihost_args, base_parser, load


def main(argv=None):
    p = base_parser(__doc__)
    add_multihost_args(p)
    p.add_argument("--weights", required=True)
    p.add_argument("--save-results", action="store_true",
                   help="write per-frame result npzs to cfg.save_results "
                        "for the pose stage (opt-in: they carry full bases "
                        "and are large)")
    p.add_argument("--eval-names", nargs="+", default=None,
                   help="evaluate several eval sets (render_data_name "
                        "values) in one process; results go to "
                        "<save_results>/<name>/")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the eval loop to "
                        "DIR/trace.json")
    args = p.parse_args(argv)
    # argparse's greedy nargs='+' swallows trailing positional overrides
    # ("--eval-names a b train.batch_size=4"); reroute anything with '='
    # so both orders work
    if args.eval_names:
        moved = [n for n in args.eval_names if "=" in n]
        args.eval_names = [n for n in args.eval_names if "=" not in n]
        args.overrides = list(args.overrides) + moved
    cfg = load(args)
    import dataclasses
    from pathlib import Path

    from ..models import DPFMNet
    from ..models.weights import flax_from_state_dict, state_dict_from_flax
    from ..train.eval_loop import build_eval_dataset, evaluate
    from ..train.loop import load_pretrained_params

    model = DPFMNet(cfg.model)
    template = {"params": flax_from_state_dict(model.state_dict())}
    params = load_pretrained_params(args.weights, template, cfg.model)
    model.load_state_dict(state_dict_from_flax(params["params"]),
                          strict=True)
    if args.eval_names:
        cfgs = [dataclasses.replace(cfg, eval_dataset=dataclasses.replace(
            cfg.eval_dataset, render_data_name=n)) for n in args.eval_names]
    else:
        cfgs = [cfg]

    def run_all():
        out = []
        for c in cfgs:
            if args.eval_names:
                name = c.eval_dataset.render_data_name
                print(f"=== {name}")
                save_dir = (Path(cfg.save_results) / name
                            if args.save_results else None)
            else:
                save_dir = cfg.save_results if args.save_results else None
            out.append(evaluate(
                c, model, dataset=build_eval_dataset(c, device=args.device),
                save_dir=save_dir, device=args.device))
        return out

    if args.profile:
        from ..utils.profiling import profile_trace
        with profile_trace(args.profile):
            return run_all()
    return run_all()


if __name__ == "__main__":
    main()
