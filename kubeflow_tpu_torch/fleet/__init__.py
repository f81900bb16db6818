"""Serving fleet control plane: the layer between model-server replicas
(the port's copy of kubeflow_tpu/fleet; stdlib only, no torch).

  endpoints.py   replica discovery (static lists or label-selected pods
                 through the kube client) + /readyz-driven readiness and
                 outlier ejection state
  router.py      load-aware HTTP reverse proxy: power-of-two-choices on
                 scraped in-flight depth, deadline and Retry-After
                 propagation, budgeted cross-replica retries, replay and
                 mid-stream failover, tier dispatch, adapter affinity,
                 drain awareness
  autoscaler.py  level-triggered control loop scaling the serving
                 Deployment from scraped kft_serving_* load gauges
  main.py        the router/autoscaler process entry point

The plane runs hermetically against in-process port replicas and
testing/fake_apiserver.py (kubeflow_tpu_torch/testing/e2e.py).
"""
