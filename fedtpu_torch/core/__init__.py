"""Local training, the federated round and the engine."""
