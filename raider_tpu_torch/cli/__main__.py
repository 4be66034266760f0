"""Process dispatcher: ``python -m raider_tpu_torch.cli ++process <name> ...``.

The counterpart of ``raider_tpu/cli/__main__.py``. ``calcDelays`` runs the
calc-delays workflow (``workflows.calc_delays``) and ``calcDelaysGUNW`` the
GUNW workflow (``workflows.gunw``) on the CUDA card unless the caller of
:func:`main` names another device; ``downloadGNSS`` (``workflows.gnss``)
downloads and parses GNSS delays on the host.
"""

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None, *, device='cuda'):
    """Parse ``argv`` (the command line when None) and run the process it
    names; returns what the process returns (calcDelays: its output paths;
    calcDelaysGUNW: its two cube paths)."""
    parser = argparse.ArgumentParser(
        prefix_chars='+',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description='raider-tpu on PyTorch and CUDA: tropospheric delay estimation',
    )
    parser.add_argument(
        '++process',
        choices=['calcDelays', 'downloadGNSS', 'calcDelaysGUNW'],
        default='calcDelays',
        help='Select the entrypoint to use',
    )
    parser.add_argument('++logger_path', required=False, help='Directory for log files')
    args, unknowns = parser.parse_known_args(argv)

    if args.logger_path:
        from raider_tpu_torch.logger import set_logger_path

        set_logger_path(args.logger_path)

    if argv is None:
        sys.argv = [sys.argv[0]] + unknowns
    if args.process == 'calcDelays':
        from raider_tpu_torch.workflows.calc_delays import calcDelays

        return calcDelays(unknowns, device=device)
    if args.process == 'downloadGNSS':
        from raider_tpu_torch.workflows.gnss import downloadGNSS

        return downloadGNSS(unknowns)
    from raider_tpu_torch.workflows.gunw import calcDelaysGUNW

    return calcDelaysGUNW(unknowns, device=device)


if __name__ == '__main__':
    main()
