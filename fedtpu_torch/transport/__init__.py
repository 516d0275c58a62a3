"""The gRPC edge of the port: fedtpu's wire formats and a client that a
fedtpu coordinator drives.

- :mod:`~fedtpu_torch.transport.proto`, :mod:`~fedtpu_torch.transport.
  msgpack`, :mod:`~fedtpu_torch.transport.wire` and :mod:`~fedtpu_torch.
  transport.sparse`: the messages, flax's msgpack form, the FTP1 and FSP1
  payloads, byte for byte fedtpu's;
- :mod:`~fedtpu_torch.transport.trainer`: ``LocalTrainer``, one client's
  rounds on the card;
- :mod:`~fedtpu_torch.transport.aggregation`: the coordinator's combine;
- :mod:`~fedtpu_torch.transport.codec_policy`: the adaptive codec policy,
  a codec a client a round from bytes x RTT;
- :mod:`~fedtpu_torch.transport.service`, :mod:`~fedtpu_torch.transport.
  retry`, :mod:`~fedtpu_torch.transport.federation` and
  :mod:`~fedtpu_torch.transport.aggregator`: the gRPC service (with the
  chaos interceptors and the client's Join and Leave), retries, the
  coordinator (``PrimaryServer``, ``BackupServer``, the membership gate),
  the client agent (``ClientAgent`` / ``serve_client``) and the mid tier
  (``AggregatorServer`` / ``serve_aggregator``).

Only those four import grpc; importing this package imports neither grpc
nor the ``msgpack`` package.
"""
