"""`python -m elasticdl_tpu_torch.master.main` — the master process
(counterpart of elasticdl_tpu/master/main.py): builds the master, starts its
threads, binds its port and starts the job's processes, then polls until
the job is done or failed; the exit code says which."""

import sys

from elasticdl_tpu_torch.common.args import master_parser, validate_args
from elasticdl_tpu_torch.master.master import Master


def main(argv=None):
    args = master_parser().parse_args(argv)
    validate_args(args)
    master = Master(args)
    master.prepare()
    master.serve()
    return master.run()


if __name__ == "__main__":
    sys.exit(main())
