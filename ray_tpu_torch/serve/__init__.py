"""ray_tpu_torch.serve: the HTTP request and response types a deployment's
``__call__`` speaks (``proxy.py``). The proxy, controller and replicas come
with serve on the port's runtime (ROADMAP Queue 1 item 4)."""
