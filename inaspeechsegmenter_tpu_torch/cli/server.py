"""CLI: job-lease server of the port's job farm (the JAX package's
``cli/server.py``, the same flags and protocol).  Host only: it takes no
device.

    python -m inaspeechsegmenter_tpu_torch.cli.server 0.0.0.0 jobs.csv \\
        --port 4040 --stop_after_dispatch
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Start the segmentation job server.')
    parser.add_argument('host', type=str,
                        help='Hostname/IP to bind and advertise to clients.')
    parser.add_argument('csvjobs', type=argparse.FileType('r'),
                        help='CSV with columns source_path, dest_path.')
    parser.add_argument('--port', type=int, default=4040)
    parser.add_argument('--stop_after_dispatch', action='store_true',
                        help='Stop once every job has been dispatched.')
    args = parser.parse_args(argv)
    args.csvjobs.close()

    from inaspeechsegmenter_tpu_torch.parallel import JobServer

    server = JobServer(args.csvjobs.name)
    srv, uri = server.serve(host=args.host, port=args.port,
                            stop_after_dispatch=args.stop_after_dispatch)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        srv.shutdown()
    srv.server_close()
    print('Done.')


if __name__ == '__main__':
    main()
