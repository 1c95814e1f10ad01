"""Train an XPoint model from a YAML config (port of ``cli/train.py``, the
reference train.py CLI).

    python -m xpoint_tpu_torch.cli.train -y CONFIG.yaml [-o DIR] [-e N]
        [--max-steps N] [--resume] [-w WEIGHTS] [--device cuda]

The ``Trainer`` writes ``params.yaml``, ``e{N}.pt`` every
``save_every_n_epoch`` epochs and ``latest.pt`` at the end into the output
directory. ``-w`` initialises the weights (strict=False) from a ``.pt`` of
this package or a reference checkpoint (``.model`` / ``.pth`` / ``.pt``,
told apart by their keys: ``Trainer.load_weights``); orbax ``.ckpt``
directories of the JAX package are not read. Runs on the card unless
``--device`` says otherwise, data parallel over every visible GPU, one rank
each, as the JAX CLI uses every chip; ``training: batchsize`` is the global
batch. With one GPU, or on the CPU, it is the one-device trainer.
"""
import argparse

from ..parallel.launch import launch
from ._common import CLI_COLLECTIVE_TIMEOUT_S, rank_count, report_at_exit


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='Train the XPoint network')
    parser.add_argument('-y', '--yaml-config', required=True,
                        help='YAML config file')
    parser.add_argument('-o', '--output-directory', default=None,
                        help='Override training.output_directory')
    parser.add_argument('-e', '--n-epochs', type=int, default=None)
    parser.add_argument('--max-steps', type=int, default=None,
                        help='Cap steps per epoch (debug)')
    parser.add_argument('--resume', action='store_true',
                        help='Resume from latest checkpoint in the output dir')
    parser.add_argument('-w', '--weight-file', default=None,
                        help='Checkpoint file (.pt of this package) to '
                             'initialize the weights from — the fine-tuning '
                             'entry point (reference train.py:21,75-84, '
                             'strict=False semantics)')
    parser.add_argument('--device', default='cuda',
                        help='torch device of the model (default: cuda)')
    return parser.parse_args(argv)


def main(argv=None):
    """Trains; returns the Trainer (None where several ranks ran)."""
    args = parse_args(argv)
    n = rank_count(args)
    if n > 1:
        launch(_train, n, args=(args, False), timeout=None,
               collective_timeout=CLI_COLLECTIVE_TIMEOUT_S)
        return None
    return _train(args)


def _train(args, keep=True):
    """Training on this rank (the only one, or one of the launched);
    returns the Trainer when ``keep``."""
    report_at_exit('train')

    from ..config import load_yaml
    from ..trainer import Trainer

    config = load_yaml(args.yaml_config)
    out_dir = args.output_directory or config['training']['output_directory']

    trainer = Trainer(config, out_dir, device=args.device)
    if args.weight_file:
        trainer.load_weights(args.weight_file)
    if args.resume:
        epoch = trainer.resume()
        if trainer.main:
            print(f"resumed from epoch {epoch}")
    trainer.train(n_epochs=args.n_epochs, max_steps_per_epoch=args.max_steps)
    return trainer if keep else None


if __name__ == '__main__':
    main()
