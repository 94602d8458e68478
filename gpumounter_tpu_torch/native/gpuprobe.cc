// gpuprobe: native NVIDIA GPU node enumerator + busy prober.
//
// The port's counterpart of gpumounter_tpu/native/tpuprobe.cc, in the
// place of the reference's native NVML layer
// (pkg/util/gpu/collector/nvml/{nvml.go,nvml_dl.go}). It reads the kernel's
// own surfaces, so it needs no NVML:
//   - scandir(/dev) for nvidiaN char nodes (N all digits), stat(2) for their
//     major:minor; a node whose major is not 195 is not a GPU and is skipped
//   - /proc/driver/nvidia/gpus/<pci>/information for each minor's UUID and
//     PCI address ("Device Minor:", "GPU UUID:", "Bus Location:")
//   - /proc/devices for driver majors (nvidia-uvm's is dynamic)
//   - /proc/<pid>/fd scan for busy detection (replaces NVML's per-GPU
//     process lists)
//
// A flat C ABI consumed from Python through ctypes
// (gpumounter_tpu_torch/device/native_enumerator.py). Every function takes
// explicit root paths, so tests point them at fixture trees.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dirent.h>
#include <string>
#include <sys/stat.h>
#include <sys/sysmacros.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr int32_t kNvidiaMajor = 195;

struct GpuInfo {
  int32_t index;
  int32_t major;
  int32_t minor;
  char device_path[256];
  char pci_address[64];
  char uuid[96];
};

struct Identity {
  int32_t minor;
  std::string uuid;
  std::string pci;
};

bool stat_chardev(const std::string& path, int32_t* major_out,
                  int32_t* minor_out) {
  struct stat st;
  if (stat(path.c_str(), &st) != 0) return false;
  if (!S_ISCHR(st.st_mode)) return false;
  *major_out = static_cast<int32_t>(major(st.st_rdev));
  *minor_out = static_cast<int32_t>(minor(st.st_rdev));
  return true;
}

// Fixture fallback: a regular file `nvidiaN` with sidecar `nvidiaN.majmin`
// ("major:minor") counts as a fake GPU node, 195:N without a sidecar.
// Mirrors PyEnumerator(allow_fake=True).
bool fixture_majmin(const std::string& path, int32_t fallback_minor,
                    int32_t* major_out, int32_t* minor_out) {
  struct stat st;
  if (stat(path.c_str(), &st) != 0 || !S_ISREG(st.st_mode)) return false;
  std::string sidecar = path + ".majmin";
  FILE* f = fopen(sidecar.c_str(), "r");
  if (f) {
    int maj = 0, min = 0;
    int n = fscanf(f, "%d:%d", &maj, &min);
    fclose(f);
    if (n == 2) {
      *major_out = maj;
      *minor_out = min;
      return true;
    }
  }
  *major_out = kNvidiaMajor;
  *minor_out = fallback_minor;
  return true;
}

// "nvidia" followed by one or more digits and nothing else.
bool gpu_node_index(const char* name, int* index) {
  static const char kPrefix[] = "nvidia";
  const size_t n = sizeof(kPrefix) - 1;
  if (strncmp(name, kPrefix, n) != 0 || name[n] == '\0') return false;
  for (const char* p = name + n; *p; p++)
    if (!isdigit(static_cast<unsigned char>(*p))) return false;
  *index = atoi(name + n);
  return true;
}

std::string trim(const std::string& s) {
  size_t b = s.find_first_not_of(" \t\r\n");
  if (b == std::string::npos) return "";
  size_t e = s.find_last_not_of(" \t\r\n");
  return s.substr(b, e - b + 1);
}

// Every <proc_root>/driver/nvidia/gpus/<pci>/information with a minor and a
// UUID. The PCI address is the file's "Bus Location", else the directory.
std::vector<Identity> read_identities(const std::string& proc_root) {
  std::vector<Identity> out;
  std::string gpus = proc_root + "/driver/nvidia/gpus";
  DIR* d = opendir(gpus.c_str());
  if (!d) return out;
  struct dirent* ent;
  while ((ent = readdir(d)) != nullptr) {
    if (ent->d_name[0] == '.') continue;
    std::string info = gpus + "/" + ent->d_name + "/information";
    FILE* f = fopen(info.c_str(), "r");
    if (!f) continue;
    Identity id{-1, "", ent->d_name};
    std::string location;
    char line[512];
    while (fgets(line, sizeof(line), f)) {
      const char* colon = strchr(line, ':');
      if (!colon) continue;
      std::string key = trim(std::string(line, colon - line));
      std::string value = trim(colon + 1);
      if (key == "Device Minor") {
        bool digits = !value.empty();
        for (char c : value)
          digits = digits && isdigit(static_cast<unsigned char>(c));
        if (digits) id.minor = atoi(value.c_str());
      } else if (key == "GPU UUID") {
        id.uuid = value;
      } else if (key == "Bus Location") {
        location = value;
      }
    }
    fclose(f);
    if (!location.empty()) id.pci = location;
    if (id.minor >= 0 && !id.uuid.empty()) out.push_back(id);
  }
  closedir(d);
  return out;
}

}  // namespace

extern "C" {

// Enumerate GPU nodes under dev_root, in index order, each with its UUID
// and PCI address from proc_root's driver tree ("" where it has none).
// Fills up to max_gpus entries of `out`; returns the number found, or a
// negative number on bad arguments.
int gpuprobe_enumerate(const char* dev_root, const char* proc_root,
                       int allow_fake, GpuInfo* out, int max_gpus) {
  if (!dev_root || !proc_root || !out || max_gpus <= 0) return -1;
  DIR* d = opendir(dev_root);
  if (!d) return 0;
  std::vector<int> indices;
  struct dirent* ent;
  while ((ent = readdir(d)) != nullptr) {
    int idx;
    if (gpu_node_index(ent->d_name, &idx)) indices.push_back(idx);
  }
  closedir(d);
  std::sort(indices.begin(), indices.end());
  std::vector<Identity> ids;
  if (!indices.empty()) ids = read_identities(proc_root);
  int n = 0;
  for (int idx : indices) {
    if (n >= max_gpus) break;
    std::string path = std::string(dev_root) + "/nvidia" + std::to_string(idx);
    GpuInfo info{};
    info.index = idx;
    if (!stat_chardev(path, &info.major, &info.minor)) {
      if (!allow_fake || !fixture_majmin(path, idx, &info.major, &info.minor))
        continue;
    }
    if (info.major != kNvidiaMajor) continue;
    snprintf(info.device_path, sizeof(info.device_path), "%s", path.c_str());
    for (const Identity& id : ids) {
      if (id.minor == info.minor) {
        snprintf(info.uuid, sizeof(info.uuid), "%s", id.uuid.c_str());
        snprintf(info.pci_address, sizeof(info.pci_address), "%s",
                 id.pci.c_str());
        break;
      }
    }
    out[n++] = info;
  }
  return n;
}

// Resolve a char-device major by driver name from <proc_root>/devices.
// Returns the major, or -1 if the name is not registered.
int gpuprobe_driver_major(const char* proc_root, const char* driver_name) {
  if (!proc_root || !driver_name) return -1;
  std::string path = std::string(proc_root) + "/devices";
  FILE* f = fopen(path.c_str(), "r");
  if (!f) return -1;
  char line[256];
  bool in_char = false;
  int result = -1;
  while (fgets(line, sizeof(line), f)) {
    if (strstr(line, "Character devices")) {
      in_char = true;
      continue;
    }
    if (strstr(line, "Block devices")) break;
    if (!in_char) continue;
    int maj;
    char name[128];
    if (sscanf(line, "%d %127s", &maj, name) == 2 &&
        strcmp(name, driver_name) == 0) {
      result = maj;
      break;
    }
  }
  fclose(f);
  return result;
}

// Busy probe: which of `pids` hold an open fd on any of `device_paths`?
// Scans <proc_root>/<pid>/fd symlinks. Writes matching pids to out_pids;
// returns the count.
int gpuprobe_open_pids(const char* proc_root, const int32_t* pids, int n_pids,
                       const char* const* device_paths, int n_paths,
                       int32_t* out_pids, int max_out) {
  if (!proc_root || !pids || !device_paths || !out_pids) return -1;
  int found = 0;
  char fd_dir[512], fd_path[1024], target[1024];
  for (int i = 0; i < n_pids && found < max_out; i++) {
    snprintf(fd_dir, sizeof(fd_dir), "%s/%d/fd", proc_root, pids[i]);
    DIR* d = opendir(fd_dir);
    if (!d) continue;  // process gone or unreadable; not busy by this probe
    struct dirent* ent;
    bool busy = false;
    while (!busy && (ent = readdir(d)) != nullptr) {
      if (ent->d_name[0] == '.') continue;
      snprintf(fd_path, sizeof(fd_path), "%s/%s", fd_dir, ent->d_name);
      ssize_t n = readlink(fd_path, target, sizeof(target) - 1);
      if (n <= 0) continue;
      target[n] = '\0';
      for (int p = 0; p < n_paths; p++) {
        if (strcmp(target, device_paths[p]) == 0) {
          busy = true;
          break;
        }
      }
    }
    closedir(d);
    if (busy) out_pids[found++] = pids[i];
  }
  return found;
}

// ABI version so the Python binding can detect stale .so builds.
int gpuprobe_abi_version(void) { return 1; }

}  // extern "C"
