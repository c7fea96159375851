/* nvidia_probe: native device-node probe helper for the GPU device plugin.
 *
 * Counterpart of the JAX package's native/tpu_probe.c for NVIDIA cards.  The
 * daemon's health loop probes every /dev/nvidiaN node once per pulse; this
 * shim runs the stat+open+close sequence, and discovery's /dev scan, in one
 * C call each, so a fast pulse costs a fixed handful of syscalls with no
 * Python object churn and the errno classification lives in one place.
 *
 * It also reads the driver's own device list through NVML
 * (libnvidia-ml.so.1, opened with dlopen at call time, so the library links
 * against nothing and loads on a host without the driver).  Discovery uses
 * it where the driver publishes no /proc/driver/nvidia/gpus entries, as in
 * a sandboxed container runtime that shows the device nodes of every card
 * but lets the container open only its own.
 *
 * Pure C; built at first use by plugin/native.py with the host's C compiler
 * and loaded with ctypes.  plugin/health.py and plugin/discovery.py keep the
 * Python sequences as the behavioural reference and the fallback for a host
 * with no compiler.  This helper replaces no TPU kernel: it is host code.
 */

#define _POSIX_C_SOURCE 200809L /* O_CLOEXEC under -std=c11 */

#include <ctype.h>
#include <dirent.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <string.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Probe result codes (mirrored in plugin/native.py). */
#define GPU_PROBE_OK 0        /* openable: healthy and idle            */
#define GPU_PROBE_BUSY 1      /* EBUSY/EACCES/EPERM: held elsewhere    */
#define GPU_PROBE_MISSING 2   /* node does not exist                   */
#define GPU_PROBE_WRONGTYPE 3 /* exists but not chardev/regular file   */
#define GPU_PROBE_OPENFAIL 4  /* other open() failure                  */

#define GPU_PROBE_ABI_VERSION 1

/* NVML's sizes (nvml.h): NVML_DEVICE_UUID_V2_BUFFER_SIZE and
 * NVML_DEVICE_PCI_BUS_ID_BUFFER_SIZE. */
#define GPU_UUID_LEN 96
#define GPU_BUS_ID_LEN 32

int gpu_probe_abi_version(void) { return GPU_PROBE_ABI_VERSION; }

/* Probe one device node.  Returns a GPU_PROBE_* code; *out_errno (optional)
 * receives the errno of the failing syscall, 0 on success. */
int gpu_probe_device(const char *path, int *out_errno) {
  struct stat st;
  if (out_errno != NULL) *out_errno = 0;
  if (stat(path, &st) != 0) {
    if (out_errno != NULL) *out_errno = errno;
    return GPU_PROBE_MISSING;
  }
  /* Real nodes are chardevs; hermetic fixture trees use regular files. */
  if (!S_ISCHR(st.st_mode) && !S_ISREG(st.st_mode)) {
    return GPU_PROBE_WRONGTYPE;
  }
  int fd = open(path, O_RDONLY | O_NONBLOCK | O_CLOEXEC);
  if (fd < 0) {
    int e = errno;
    if (out_errno != NULL) *out_errno = e;
    /* A node the device cgroup keeps for another container, or one held
     * exclusively (compute mode EXCLUSIVE_PROCESS), is alive. */
    if (e == EBUSY || e == EACCES || e == EPERM) return GPU_PROBE_BUSY;
    return GPU_PROBE_OPENFAIL;
  }
  close(fd);
  return GPU_PROBE_OK;
}

/* Probe a batch of nodes in one FFI crossing.  paths is an array of n
 * C strings; codes (and optionally errnos) receive n results. */
void gpu_probe_devices(const char *const *paths, int n, int *codes,
                       int *errnos) {
  for (int i = 0; i < n; i++) {
    codes[i] = gpu_probe_device(paths[i], errnos != NULL ? &errnos[i] : NULL);
  }
}

/* Scan a directory for nvidiaN entries (discovery's /dev enumeration):
 * exactly `nvidia` + decimal digits, so nvidiactl, nvidia-uvm,
 * nvidia-modeset and nvidia-caps are not cards.  Writes up to cap minors
 * into out (unsorted) and returns the number found, or -1 on opendir
 * failure; a count > cap means the buffer was too small. */
int gpu_scan_nvidia_minors(const char *dev_dir, int *out, int cap) {
  DIR *d = opendir(dev_dir);
  if (d == NULL) return -1;
  int n = 0;
  struct dirent *ent;
  while ((ent = readdir(d)) != NULL) {
    const char *name = ent->d_name;
    if (strncmp(name, "nvidia", 6) != 0) continue;
    const char *digits = name + 6;
    if (*digits == '\0') continue;
    long idx = 0;
    int ok = 1;
    for (const char *p = digits; *p != '\0'; p++) {
      if (!isdigit((unsigned char)*p) || idx > 1000000) {
        ok = 0;
        break;
      }
      idx = idx * 10 + (*p - '0');
    }
    if (!ok) continue;
    if (n < cap) out[n] = (int)idx;
    n++;
  }
  closedir(d);
  return n;
}

/* ---- NVML, opened at call time --------------------------------------- */

typedef int nvml_return_t; /* nvmlReturn_t; 0 is NVML_SUCCESS */
typedef void *nvml_device_t;

/* nvmlPciInfo_t as nvmlDeviceGetPciInfo_v3 fills it. */
typedef struct {
  char bus_id_legacy[16];
  unsigned int domain;
  unsigned int bus;
  unsigned int device;
  unsigned int pci_device_id; /* device id << 16 | vendor id */
  unsigned int pci_subsystem_id;
  char bus_id[GPU_BUS_ID_LEN];
} nvml_pci_info_t;

/* Error codes of gpu_nvml_devices, below any count. */
#define GPU_NVML_NO_LIBRARY -1
#define GPU_NVML_NO_SYMBOL -2
#define GPU_NVML_INIT_FAILED -3
#define GPU_NVML_QUERY_FAILED -4

/* The driver's cards as NVML lists them, in NVML index order: for each,
 * its device-node minor, UUID ("GPU-..."), PCI bus id ("00000000:18:00.0")
 * and PCI ids (pci_ids[i] holds device id << 16 | vendor id, as NVML packs
 * them; an empty bus id and 0 where NVML reports no PCI information).
 * uuids and bus_ids are cap rows of
 * GPU_UUID_LEN and GPU_BUS_ID_LEN bytes.  Returns the count (possibly
 * > cap: rows past cap are not written) or a GPU_NVML_* error; *nvml_status
 * gets NVML's own code of the failing call. */
int gpu_nvml_devices(int *minors, char *uuids, char *bus_ids,
                     unsigned int *pci_ids, int cap, int *nvml_status) {
  *nvml_status = 0;
  void *lib = dlopen("libnvidia-ml.so.1", RTLD_NOW | RTLD_LOCAL);
  if (lib == NULL) return GPU_NVML_NO_LIBRARY;
  nvml_return_t (*init)(void) = (nvml_return_t(*)(void))dlsym(lib, "nvmlInit_v2");
  nvml_return_t (*shutdown)(void) =
      (nvml_return_t(*)(void))dlsym(lib, "nvmlShutdown");
  nvml_return_t (*count_fn)(unsigned int *) =
      (nvml_return_t(*)(unsigned int *))dlsym(lib, "nvmlDeviceGetCount_v2");
  nvml_return_t (*handle_fn)(unsigned int, nvml_device_t *) =
      (nvml_return_t(*)(unsigned int, nvml_device_t *))dlsym(
          lib, "nvmlDeviceGetHandleByIndex_v2");
  nvml_return_t (*minor_fn)(nvml_device_t, unsigned int *) =
      (nvml_return_t(*)(nvml_device_t, unsigned int *))dlsym(
          lib, "nvmlDeviceGetMinorNumber");
  nvml_return_t (*uuid_fn)(nvml_device_t, char *, unsigned int) =
      (nvml_return_t(*)(nvml_device_t, char *, unsigned int))dlsym(
          lib, "nvmlDeviceGetUUID");
  nvml_return_t (*pci_fn)(nvml_device_t, nvml_pci_info_t *) =
      (nvml_return_t(*)(nvml_device_t, nvml_pci_info_t *))dlsym(
          lib, "nvmlDeviceGetPciInfo_v3");
  if (!init || !shutdown || !count_fn || !handle_fn || !minor_fn ||
      !uuid_fn || !pci_fn) {
    dlclose(lib);
    return GPU_NVML_NO_SYMBOL;
  }
  nvml_return_t rc = init();
  if (rc != 0) {
    *nvml_status = rc;
    dlclose(lib);
    return GPU_NVML_INIT_FAILED;
  }
  unsigned int count = 0;
  int result = 0;
  rc = count_fn(&count);
  if (rc != 0) {
    result = GPU_NVML_QUERY_FAILED;
  } else {
    result = (int)count;
    for (unsigned int i = 0; i < count && (int)i < cap; i++) {
      nvml_device_t dev;
      unsigned int minor = 0;
      nvml_pci_info_t pci;
      memset(&pci, 0, sizeof(pci));
      char *uuid = uuids + (size_t)i * GPU_UUID_LEN;
      char *bus = bus_ids + (size_t)i * GPU_BUS_ID_LEN;
      uuid[0] = '\0';
      if ((rc = handle_fn(i, &dev)) != 0 || (rc = minor_fn(dev, &minor)) != 0 ||
          (rc = uuid_fn(dev, uuid, GPU_UUID_LEN)) != 0) {
        result = GPU_NVML_QUERY_FAILED;
        break;
      }
      minors[i] = (int)minor;
      uuid[GPU_UUID_LEN - 1] = '\0';
      /* A virtualised driver may not report PCI information
       * (NVML_ERROR_NOT_SUPPORTED): the row then has an empty bus id and
       * zero ids, and the card is still listed. */
      bus[0] = '\0';
      pci_ids[i] = 0;
      if (pci_fn(dev, &pci) == 0) {
        memcpy(bus, pci.bus_id, GPU_BUS_ID_LEN);
        bus[GPU_BUS_ID_LEN - 1] = '\0';
        pci_ids[i] = pci.pci_device_id;
      }
    }
  }
  if (result == GPU_NVML_QUERY_FAILED) *nvml_status = rc;
  shutdown();
  dlclose(lib);
  return result;
}

#ifdef __cplusplus
} /* extern "C" */
#endif
