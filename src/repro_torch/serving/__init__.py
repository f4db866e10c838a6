"""Serving: the control plane and its policies, the discrete-event
simulator, the stage-graph engine, the controller bundles, and
cluster-mode execution (``cluster.ClusterRuntime``)."""
