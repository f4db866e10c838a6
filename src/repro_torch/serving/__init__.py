"""Cluster-mode execution: ``cluster.ClusterRuntime``."""
