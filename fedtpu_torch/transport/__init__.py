"""The gRPC edge of the port: fedtpu's wire formats and a client that a
fedtpu coordinator drives.

- :mod:`~fedtpu_torch.transport.proto`, :mod:`~fedtpu_torch.transport.
  msgpack`, :mod:`~fedtpu_torch.transport.wire` and :mod:`~fedtpu_torch.
  transport.sparse`: the messages, flax's msgpack form, the FTP1 and FSP1
  payloads, byte for byte fedtpu's;
- :mod:`~fedtpu_torch.transport.trainer`: ``LocalTrainer``, one client's
  rounds on the card;
- :mod:`~fedtpu_torch.transport.aggregation`: the coordinator's combine;
- :mod:`~fedtpu_torch.transport.service`, :mod:`~fedtpu_torch.transport.
  retry` and :mod:`~fedtpu_torch.transport.federation`: the gRPC service,
  retries, and ``ClientAgent`` / ``serve_client``.

Only the last three import grpc; importing this package imports neither
grpc nor the ``msgpack`` package.
"""
