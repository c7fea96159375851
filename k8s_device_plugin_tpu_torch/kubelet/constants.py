"""Protocol constants for the kubelet device-plugin API (v1beta1).

The port's own copy of the JAX package's ``kubelet/constants.py`` (the
port imports nothing of that package); the wire contract is unchanged.

Mirrors the contract constants the kubelet hard-codes (reference analogue:
vendored deviceplugin/v1beta1/constants.go:19-35).  These values are part of
the kubelet's public API surface and must match exactly.
"""

# Device health states streamed in ListAndWatchResponse.
HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

# API version announced in RegisterRequest.version.
VERSION = "v1beta1"

# Directory in which the kubelet serves kubelet.sock and expects plugin
# sockets to appear.
DEVICE_PLUGIN_PATH = "/var/lib/kubelet/device-plugins/"

# The kubelet's own Registration socket.
KUBELET_SOCKET_NAME = "kubelet.sock"
KUBELET_SOCKET = DEVICE_PLUGIN_PATH + KUBELET_SOCKET_NAME

# Upper bound the kubelet applies to a PreStartContainer RPC.
PRE_START_CONTAINER_TIMEOUT_SECONDS = 30

# gRPC method paths, fixed by the proto package/service/method names.
REGISTRATION_SERVICE = "v1beta1.Registration"
DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"

# The kubelet's PodResources introspection endpoint (podresources/v1):
# which pod/container currently holds which device IDs — the kubelet-truth
# side of the plugin's allocation-reconciliation audit.
POD_RESOURCES_PATH = "/var/lib/kubelet/pod-resources/"
POD_RESOURCES_SOCKET_NAME = "kubelet.sock"
POD_RESOURCES_SOCKET = POD_RESOURCES_PATH + POD_RESOURCES_SOCKET_NAME
POD_RESOURCES_SERVICE = "v1.PodResourcesLister"
