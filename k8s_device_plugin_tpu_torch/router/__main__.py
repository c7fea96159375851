"""`python -m k8s_device_plugin_tpu_torch.router` — the router daemon entry
(deploy/k8s-deploy-router-gpu.yaml).

The port's own copy of the reference's ``router/__main__.py`` (the port imports
nothing of the JAX package): the same names, wire and metrics, its
imports pointed at the port's own modules.
"""

from .server import main

if __name__ == "__main__":
    main()
