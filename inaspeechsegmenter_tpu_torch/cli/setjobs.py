"""CLI: re-feed a running job server (the JAX package's
``cli/setjobs.py``, the same arguments and protocol).

    python -m inaspeechsegmenter_tpu_torch.cli.setjobs tcp://host:4040 jobs.csv
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Feed a new job csv (source_path,dest_path columns) to '
                    'a running job server.')
    parser.add_argument('uri', type=str,
                        help='Server uri, e.g. tcp://host:4040')
    parser.add_argument('csvjobs', type=str,
                        help='csv file with source_path,dest_path columns')
    args = parser.parse_args(argv)

    from inaspeechsegmenter_tpu_torch.parallel import JobClient

    client = JobClient(args.uri)
    print(client.set_jobs(args.csvjobs))
    client.close()


if __name__ == '__main__':
    main()
