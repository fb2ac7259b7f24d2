"""ray_tpu_torch.serve: the HTTP request and response types a deployment's
``__call__`` speaks (``proxy.py``). The proxy, controller and replicas come
with the runtime."""
