"""Operating-point sweep for the registration benchmark (port of
``tools/op_sweep.py``).

Re-evaluates a trained checkpoint over a grid of prediction operating
points (detection threshold x NMS radius x top-k cap) without retraining:
each point rewrites the ``prediction:`` block of the cycle's eval YAML and
runs ``python -m xpoint_tpu_torch.cli.benchmark -e``. Prints a table of the
three decision metrics and writes the grid to a JSON file.

    python -m xpoint_tpu_torch.tools.op_sweep --work WORK \\
        [--model WORK/pair-train] [--eval-yaml WORK/eval.yaml] [--seed 0] \\
        [--out outputs/op_sweep.json] [--grid "det,nms,topk;..."] \\
        [--device cuda] [--max-samples N]

``--out`` is relative to the repository (not the JAX tool's default,
``metrics/exp/op_sweep.json``); ``--device`` and ``--max-samples`` (the
first N pairs; default every pair, as the JAX tool) are the benchmark's.
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (detection_threshold, nms, topk) grid: committed point first, then
# sparser points that trade h@3 for NN-mAP
DEFAULT_GRID = [
    (0.001, 4, 0),
    (0.005, 4, 0),
    (0.010, 4, 0),
    (0.015, 4, 0),
    (0.005, 8, 0),
    (0.010, 8, 0),
    (0.001, 4, 1024),
    (0.001, 4, 512),
    (0.005, 4, 512),
]


def rewrite(eval_yaml, out_yaml, det, nms, topk):
    lines = open(eval_yaml).read().splitlines(keepends=True)
    out = []
    for ln in lines:
        s = ln.strip()
        if s.startswith('detection_threshold:'):
            ln = ln.split('detection_threshold:')[0] + \
                f'detection_threshold: {det}\n'
        elif s.startswith('nms:'):
            ln = ln.split('nms:')[0] + f'nms: {nms}\n'
        elif s.startswith('topk:'):
            ln = ln.split('topk:')[0] + f'topk: {topk}\n'
        out.append(ln)
    with open(out_yaml, 'w') as f:
        f.write(''.join(out))


def parse_grid(text):
    return [tuple(float(x) if '.' in x else int(x) for x in p.split(','))
            for p in text.split(';')]


def point_row(m, det, nms, topk):
    """The table's row from a benchmark JSON."""
    return dict(
        det=det, nms=int(nms), topk=int(topk),
        h3=m['homography']['2']['h_correctness']['epsilon_warp_th3'],
        h3_dev=m.get('homography_device', {}).get('2', {}).get(
            'h_correctness', {}).get('epsilon_warp_th3'),
        nn_map3=m['descriptor']['3']['nn_map'],
        m_score3=m['descriptor']['3']['m_score'],
        rep3=m['repeatability']['3'],
        n_kp=sum(m['n_kp_optical']) / len(m['n_kp_optical']),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--work', required=True)
    ap.add_argument('--model', default=None)
    ap.add_argument('--eval-yaml', default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', default='outputs/op_sweep.json')
    ap.add_argument('--grid', default=None,
                    help='semicolon list "det,nms,topk;..." '
                         '(default: the built-in 9-point grid)')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--max-samples', default=None, type=int)
    args = ap.parse_args(argv)

    model = args.model or f'{args.work}/pair-train'
    eval_yaml = args.eval_yaml or f'{args.work}/eval.yaml'
    grid = parse_grid(args.grid) if args.grid else DEFAULT_GRID
    py = sys.executable

    rows = []
    for det, nms, topk in grid:
        tag = f'det{det}_nms{nms}_tk{topk}'
        ydir = f'{args.work}/opsweep'
        os.makedirs(ydir, exist_ok=True)
        yml = f'{ydir}/eval_{tag}.yaml'
        rewrite(eval_yaml, yml, det, int(nms), int(topk))
        odir = f'{ydir}/out_{tag}'
        cmd = [py, '-m', 'xpoint_tpu_torch.cli.benchmark', '-y', yml, '-m',
               model, '-e', '-s', str(args.seed), '-o', odir, '--device',
               args.device]
        if args.max_samples:
            cmd += ['--max-samples', str(args.max_samples)]
        print('+', ' '.join(cmd), flush=True)
        subprocess.run(cmd, cwd=REPO, check=True)
        fn = [f for f in os.listdir(odir) if f.endswith('.json')][0]
        with open(os.path.join(odir, fn)) as f:
            row = point_row(json.load(f), det, nms, topk)
        rows.append(row)
        print(f"  -> h@3 {row['h3']:.4f}  NN-mAP@3 {row['nn_map3']:.4f}  "
              f"m-score@3 {row['m_score3']:.4f}  rep@3 {row['rep3']:.3f}  "
              f"kp {row['n_kp']:.0f}", flush=True)

    outp = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(outp), exist_ok=True)
    with open(outp, 'w') as f:
        json.dump(dict(model=model, seed=args.seed, grid=rows), f, indent=1)
    print(f'written to {outp}', flush=True)
    return rows


if __name__ == '__main__':
    main()
