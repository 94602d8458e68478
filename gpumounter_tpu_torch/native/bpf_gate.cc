// bpf_gate: cgroup-v2 device-access gating via BPF_PROG_TYPE_CGROUP_DEVICE.
//
// A copy of the control plane's gpumounter_tpu/native/bpf_gate.cc, built into
// the port's own build/libbpfgate.so. It keys on (type, major, minor) and
// holds no device-family logic; the program and map names are the control
// plane's, so either package's gate adopts a map the other attached.
//
// The reference only supports cgroup v1, where granting device access is a
// file write: `echo "c 195:0 rw" > .../devices.allow`
// (pkg/util/cgroup/cgroup.go:143-155). On cgroup v2 (GKE >= 1.26) that file
// does not exist; device access is decided by eBPF programs attached to the
// cgroup. Kernel semantics: with multiple attached programs the verdict is the
// AND of all of them — so permissions cannot be *extended* by attaching an
// extra allow-program next to the container runtime's. The only sound way to
// add a device is to REPLACE the runtime's program with one that allows
// (previous set ∪ new devices). Since slave-pod allocation never modifies the
// target pod's spec (that is the whole point of the design, SURVEY.md §0),
// the runtime's program is the standard runc/crun default allowlist; the
// Python layer (gpumounter_tpu_torch/actuation/cgroup.py) passes
// default-rules + currently-attached GPUs as one explicit rule list and this
// layer makes the cgroup match it exactly ("sync", not "add"/"remove").
//
// Everything privileged is isolated here; program *codegen* is pure and
// unit-testable without CAP_BPF (tests inspect the emitted instruction
// stream).
//
// No libbpf dependency: the program is a short, hand-assembled instruction
// sequence in the classic runc devcg shape, loaded with raw bpf(2) syscalls.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <vector>

// ---- minimal local uapi (kept self-contained; values are kernel ABI) --------

struct bpf_insn {
  uint8_t code;
  uint8_t dst_reg : 4;
  uint8_t src_reg : 4;
  int16_t off;
  int32_t imm;
};

// instruction classes
#define BPF_LD 0x00
#define BPF_LDX 0x01
#define BPF_ST 0x02
#define BPF_STX 0x03
#define BPF_ALU 0x04
#define BPF_JMP 0x05
#define BPF_JMP32 0x06
#define BPF_ALU64 0x07
// size
#define BPF_W 0x00
#define BPF_DW 0x18
// mode
#define BPF_IMM 0x00
#define BPF_MEM 0x60
#define BPF_ATOMIC 0xc0
// alu/jmp ops
#define BPF_ADD 0x00
#define BPF_OR 0x40
#define BPF_AND 0x50
#define BPF_RSH 0x70
#define BPF_MOV 0xb0
#define BPF_JEQ 0x10
#define BPF_JNE 0x50
#define BPF_CALL 0x80
#define BPF_EXIT 0x90
// source
#define BPF_K 0x00
#define BPF_X 0x08
// pseudo src_reg for ld_imm64: imm is a map fd
#define BPF_PSEUDO_MAP_FD 1
// helper ids
#define BPF_FUNC_map_lookup_elem 1

// prog/attach types
#define BPF_PROG_TYPE_CGROUP_DEVICE 15
#define BPF_CGROUP_DEVICE 6
// map types
#define BPF_MAP_TYPE_HASH 1
// bpf(2) commands
#define BPF_CMD_MAP_CREATE 0
#define BPF_CMD_MAP_LOOKUP_ELEM 1
#define BPF_CMD_MAP_UPDATE_ELEM 2
#define BPF_CMD_MAP_DELETE_ELEM 3
#define BPF_CMD_MAP_GET_NEXT_KEY 4
#define BPF_CMD_PROG_LOAD 5
#define BPF_CMD_PROG_ATTACH 8
#define BPF_CMD_PROG_DETACH 9
#define BPF_CMD_PROG_QUERY 16
#define BPF_CMD_PROG_GET_FD_BY_ID 13
#define BPF_CMD_MAP_GET_FD_BY_ID 14
#define BPF_CMD_OBJ_GET_INFO_BY_FD 15
// attach flags
#define BPF_F_ALLOW_MULTI (1u << 1)
#define BPF_F_REPLACE (1u << 2)
// map update flags
#define BPF_MAP_UPDATE_ANY 0

// device types in bpf_cgroup_dev_ctx.access_type low 16 bits
#define BPF_DEVCG_DEV_BLOCK 1
#define BPF_DEVCG_DEV_CHAR 2
// access bits in high 16 bits
#define BPF_DEVCG_ACC_MKNOD 1
#define BPF_DEVCG_ACC_READ 2
#define BPF_DEVCG_ACC_WRITE 4

// union bpf_attr fragments we need (zero-padded to kernel expectations)
struct bpf_attr_prog_load {
  uint32_t prog_type;
  uint32_t insn_cnt;
  uint64_t insns;
  uint64_t license;
  uint32_t log_level;
  uint32_t log_size;
  uint64_t log_buf;
  uint32_t kern_version;
  uint32_t prog_flags;
  char prog_name[16];
  uint32_t prog_ifindex;
  uint32_t expected_attach_type;
};

struct bpf_attr_attach {
  uint32_t target_fd;
  uint32_t attach_bpf_fd;
  uint32_t attach_type;
  uint32_t attach_flags;
  uint32_t replace_bpf_fd;
};

// Full modern layout of the kernel's PROG_QUERY attr. This must NOT be
// truncated to the fields this code reads: since ~v6.16 the cgroup query
// path copy_to_user()s `revision` at offset 56 unconditionally, so an
// attr smaller than that gets its stack neighbours (incl. the return
// address, at -O2 frame layouts) silently overwritten — observed as a
// wild jump to address 3 on kernel 6.18.
struct bpf_attr_query {
  uint32_t target_fd;
  uint32_t attach_type;
  uint32_t query_flags;
  uint32_t attach_flags;
  uint64_t prog_ids;
  uint32_t prog_cnt;
  uint32_t pad0;
  uint64_t prog_attach_flags;
  uint64_t link_ids;
  uint64_t link_attach_flags;
  uint64_t revision;
};
static_assert(sizeof(bpf_attr_query) == 64, "kernel PROG_QUERY attr layout");

struct bpf_attr_get_fd_by_id {
  uint32_t id;
};

struct bpf_attr_obj_info {
  uint32_t bpf_fd;
  uint32_t info_len;
  uint64_t info;
};

struct bpf_attr_map_create {
  uint32_t map_type;
  uint32_t key_size;
  uint32_t value_size;
  uint32_t max_entries;
  uint32_t map_flags;
  uint32_t inner_map_fd;
  uint32_t numa_node;
  char map_name[16];
};

// BPF_MAP_*_ELEM / GET_NEXT_KEY attr: key/value pointers are u64-aligned,
// so the u32 map_fd needs explicit padding before them.
struct bpf_attr_map_elem {
  uint32_t map_fd;
  uint32_t pad0;
  uint64_t key;
  uint64_t value;  // doubles as next_key for GET_NEXT_KEY
  uint64_t flags;
};

// Leading fields of struct bpf_prog_info (kernel tolerates a truncated
// info_len and fills only what fits) — enough for xlated read-back.
struct bpf_prog_info_min {
  uint32_t type;
  uint32_t id;
  uint8_t tag[8];
  uint32_t jited_prog_len;
  uint32_t xlated_prog_len;
  uint64_t jited_prog_insns;
  uint64_t xlated_prog_insns;
};

// Extended prefix: through name[16] (offset 64), so map adoption can match
// an attached program by name and walk its map ids.
struct bpf_prog_info_named {
  uint32_t type;
  uint32_t id;
  uint8_t tag[8];
  uint32_t jited_prog_len;
  uint32_t xlated_prog_len;
  uint64_t jited_prog_insns;
  uint64_t xlated_prog_insns;
  uint64_t load_time;
  uint32_t created_by_uid;
  uint32_t nr_map_ids;
  uint64_t map_ids;
  char name[16];
};
static_assert(sizeof(bpf_prog_info_named) == 80, "bpf_prog_info prefix");

static long sys_bpf(int cmd, void* attr, unsigned int size) {
  return syscall(__NR_bpf, cmd, attr, size);
}

// ---- public rule ABI --------------------------------------------------------

extern "C" {

// One device rule, mirroring an OCI linux.resources.devices entry.
// dev_type: 'c', 'b', or 'a' (all). access: OR of BPF_DEVCG_ACC_*.
// has_major/has_minor 0 means wildcard (*).
struct DeviceRule {
  int32_t dev_type;
  int32_t access;
  int32_t major;
  int32_t minor;
  int32_t has_major;
  int32_t has_minor;
};

}  // extern "C"

// ---- codegen ---------------------------------------------------------------

namespace {

bpf_insn ldx_w(uint8_t dst, uint8_t src, int16_t off) {
  return bpf_insn{BPF_LDX | BPF_MEM | BPF_W, dst, src, off, 0};
}
bpf_insn alu32_imm(uint8_t op, uint8_t dst, int32_t imm) {
  return bpf_insn{static_cast<uint8_t>(BPF_ALU | op | BPF_K), dst, 0, 0, imm};
}
bpf_insn mov32_reg(uint8_t dst, uint8_t src) {
  return bpf_insn{BPF_ALU | BPF_MOV | BPF_X, dst, src, 0, 0};
}
bpf_insn mov64_imm(uint8_t dst, int32_t imm) {
  return bpf_insn{BPF_ALU64 | BPF_MOV | BPF_K, dst, 0, 0, imm};
}
bpf_insn jmp32_imm(uint8_t op, uint8_t dst, int32_t imm, int16_t off) {
  return bpf_insn{static_cast<uint8_t>(BPF_JMP32 | op | BPF_K), dst, 0, off,
                  imm};
}
bpf_insn jmp32_reg(uint8_t op, uint8_t dst, uint8_t src, int16_t off) {
  return bpf_insn{static_cast<uint8_t>(BPF_JMP32 | op | BPF_X), dst, src, off,
                  0};
}
bpf_insn exit_insn() { return bpf_insn{BPF_JMP | BPF_EXIT, 0, 0, 0, 0}; }

// Emit the allowlist program. Register plan (ctx arrives in r1):
//   r2 = device type, r3 = requested access, r4 = major, r5 = minor,
//   r1 reused as scratch after the prologue.
// Each rule is a fall-through chain of conditional skips ending in
// `r0 = 1; exit`; the epilogue is `r0 = 0; exit` (deny).
std::vector<bpf_insn> build_program(const DeviceRule* rules, int n_rules) {
  std::vector<bpf_insn> p;
  // prologue: unpack bpf_cgroup_dev_ctx {access_type, major, minor}
  p.push_back(ldx_w(2, 1, 0));               // r2 = access_type
  p.push_back(alu32_imm(BPF_AND, 2, 0xFFFF));  // r2 &= 0xFFFF (type)
  p.push_back(ldx_w(3, 1, 0));               // r3 = access_type
  p.push_back(alu32_imm(BPF_RSH, 3, 16));    // r3 >>= 16 (access bits)
  p.push_back(ldx_w(4, 1, 4));               // r4 = major
  p.push_back(ldx_w(5, 1, 8));               // r5 = minor

  for (int i = 0; i < n_rules; i++) {
    const DeviceRule& r = rules[i];
    // Per rule: fall-through chain [type?, access, major?, minor?] ending in
    // `r0 = 1; exit`. A failed check jumps past the allow pair, to the next
    // rule (or the deny epilogue).
    std::vector<bpf_insn> checks;
    if (r.dev_type != 'a') {
      int type_val =
          (r.dev_type == 'b') ? BPF_DEVCG_DEV_BLOCK : BPF_DEVCG_DEV_CHAR;
      checks.push_back(jmp32_imm(BPF_JNE, 2, type_val, 0));
    }
    // access: allowed iff (requested & rule.access) == requested
    checks.push_back(mov32_reg(1, 3));                 // r1 = requested
    checks.push_back(alu32_imm(BPF_AND, 1, r.access)); // r1 &= allowed
    checks.push_back(jmp32_reg(BPF_JNE, 1, 3, 0));     // some bit missing
    if (r.has_major)
      checks.push_back(jmp32_imm(BPF_JNE, 4, r.major, 0));
    if (r.has_minor)
      checks.push_back(jmp32_imm(BPF_JNE, 5, r.minor, 0));

    // A jump at index c with offset o lands at c + 1 + o; failures must land
    // just past [allow, exit], i.e. at index n_checks + 2.
    int n_checks = static_cast<int>(checks.size());
    for (int c = 0; c < n_checks; c++) {
      bool is_jump = (checks[c].code & 0x07) == BPF_JMP32;
      if (is_jump)
        checks[c].off = static_cast<int16_t>(n_checks + 2 - (c + 1));
    }
    for (auto& ins : checks) p.push_back(ins);
    p.push_back(mov64_imm(0, 1));
    p.push_back(exit_insn());
  }
  p.push_back(mov64_imm(0, 0));
  p.push_back(exit_insn());
  return p;
}

}  // namespace

// ---- map-driven gate (PR 12) -----------------------------------------------
//
// The program-replacement sync above makes every grant/revoke a full
// load+replace — a race window per mutation and a verifier round-trip on the
// revocation path. The map-driven variant attaches ONE program per cgroup
// whose policy lives in a BPF hash map keyed by (type, major, minor) →
// {access bits, open count}; grant/revoke become in-place map updates with
// no program replacement at all. The program also keeps exact per-syscall
// accounting: each allowed open bumps the matched key's counter atomically,
// each denied access bumps the reserved deny key {0,0,0} — the audit
// counters gpu_ext (PAPERS.md) argues for, read back by the worker.

// Map key/value ABI (also mirrored by the Python binding for read-back).
// Wildcard major/minor is encoded as 0xFFFFFFFF; the deny counter lives
// under the reserved key {0,0,0} (dev_type 0 is not a valid device type).
struct GateKey {
  uint32_t dev_type;  // 'c' | 'b' (a rule with type 'a' expands to both)
  uint32_t major;
  uint32_t minor;
};
struct GateVal {
  uint32_t access;
  uint32_t opens;
};
#define GATE_WILDCARD 0xFFFFFFFFu
#define GATE_MAP_MAX_ENTRIES 1024
static const char kGateMapProgName[] = "tpumtr_map";

namespace {

bpf_insn st_w_imm(uint8_t dst, int16_t off, int32_t imm) {
  return bpf_insn{BPF_ST | BPF_MEM | BPF_W, dst, 0, off, imm};
}
bpf_insn stx_w(uint8_t dst, uint8_t src, int16_t off) {
  return bpf_insn{BPF_STX | BPF_MEM | BPF_W, dst, src, off, 0};
}
bpf_insn mov64_reg(uint8_t dst, uint8_t src) {
  return bpf_insn{BPF_ALU64 | BPF_MOV | BPF_X, dst, src, 0, 0};
}
bpf_insn add64_imm(uint8_t dst, int32_t imm) {
  return bpf_insn{BPF_ALU64 | BPF_ADD | BPF_K, dst, 0, 0, imm};
}
bpf_insn alu32_reg(uint8_t op, uint8_t dst, uint8_t src) {
  return bpf_insn{static_cast<uint8_t>(BPF_ALU | op | BPF_X), dst, src, 0,
                  0};
}
bpf_insn jmp64_imm(uint8_t op, uint8_t dst, int32_t imm, int16_t off) {
  return bpf_insn{static_cast<uint8_t>(BPF_JMP | op | BPF_K), dst, 0, off,
                  imm};
}
bpf_insn call_insn(int32_t helper) {
  return bpf_insn{BPF_JMP | BPF_CALL, 0, 0, 0, helper};
}
bpf_insn xadd_w(uint8_t dst, uint8_t src, int16_t off) {
  return bpf_insn{BPF_STX | BPF_ATOMIC | BPF_W, dst, src, off, BPF_ADD};
}

// Stack layout (r10 = frame pointer): key at fp-16 {type, major, minor},
// accumulated allowed-access union at fp-24. Ctx fields are unpacked into
// callee-saved r6..r9 because helper calls clobber r1-r5.
constexpr int16_t kKeyOff = -16;
constexpr int16_t kAccOff = -24;

// Emit one "store key, lookup, OR the hit's access bits into fp-24" block.
// major/minor come from a register (device's own) or an immediate wildcard.
void emit_lookup(std::vector<bpf_insn>* p, int map_fd, bool wild_major,
                 bool wild_minor) {
  p->push_back(stx_w(10, 6, kKeyOff));                     // key.type = r6
  if (wild_major)
    p->push_back(st_w_imm(10, kKeyOff + 4, GATE_WILDCARD));
  else
    p->push_back(stx_w(10, 8, kKeyOff + 4));               // key.major = r8
  if (wild_minor)
    p->push_back(st_w_imm(10, kKeyOff + 8, GATE_WILDCARD));
  else
    p->push_back(stx_w(10, 9, kKeyOff + 8));               // key.minor = r9
  bpf_insn ld = bpf_insn{BPF_LD | BPF_IMM | BPF_DW, 1, BPF_PSEUDO_MAP_FD, 0,
                         map_fd};
  p->push_back(ld);
  p->push_back(bpf_insn{0, 0, 0, 0, 0});                   // ld_imm64 half
  p->push_back(mov64_reg(2, 10));
  p->push_back(add64_imm(2, kKeyOff));
  p->push_back(call_insn(BPF_FUNC_map_lookup_elem));
  p->push_back(jmp64_imm(BPF_JEQ, 0, 0, 4));               // miss: skip 4
  p->push_back(ldx_w(1, 0, 0));                            // r1 = access
  p->push_back(ldx_w(2, 10, kAccOff));
  p->push_back(alu32_reg(BPF_OR, 2, 1));
  p->push_back(stx_w(10, 2, kAccOff));
}

// The map-driven device program. Verdict: union the access bits of the
// exact, (major,*), (*,minor) and (*,*) entries for the device's type;
// allow iff every requested bit is granted. Allowed opens bump the exact
// key's counter; denials bump the reserved deny key.
std::vector<bpf_insn> build_map_program(int map_fd) {
  std::vector<bpf_insn> p;
  // prologue: unpack bpf_cgroup_dev_ctx into callee-saved registers
  p.push_back(ldx_w(6, 1, 0));                 // r6 = access_type
  p.push_back(alu32_imm(BPF_AND, 6, 0xFFFF));  // r6 &= 0xFFFF (type)
  p.push_back(ldx_w(7, 1, 0));
  p.push_back(alu32_imm(BPF_RSH, 7, 16));      // r7 = requested access
  p.push_back(ldx_w(8, 1, 4));                 // r8 = major
  p.push_back(ldx_w(9, 1, 8));                 // r9 = minor
  p.push_back(st_w_imm(10, kAccOff, 0));       // allowed-union = 0
  emit_lookup(&p, map_fd, false, false);
  emit_lookup(&p, map_fd, false, true);
  emit_lookup(&p, map_fd, true, false);
  emit_lookup(&p, map_fd, true, true);
  // verdict: (requested & allowed) == requested ?
  p.push_back(ldx_w(1, 10, kAccOff));
  p.push_back(mov32_reg(2, 7));
  p.push_back(alu32_reg(BPF_AND, 2, 1));
  // deny path starts 13 insns past this jump (the allow block below)
  p.push_back(jmp32_reg(BPF_JNE, 2, 7, 13));
  // allow: re-lookup the exact key and bump its open counter (best-effort:
  // a concurrent revoke may have deleted it between lookups — still allow,
  // the union already granted this access)
  p.push_back(stx_w(10, 6, kKeyOff));
  p.push_back(stx_w(10, 8, kKeyOff + 4));
  p.push_back(stx_w(10, 9, kKeyOff + 8));
  p.push_back(bpf_insn{BPF_LD | BPF_IMM | BPF_DW, 1, BPF_PSEUDO_MAP_FD, 0,
                       map_fd});
  p.push_back(bpf_insn{0, 0, 0, 0, 0});
  p.push_back(mov64_reg(2, 10));
  p.push_back(add64_imm(2, kKeyOff));
  p.push_back(call_insn(BPF_FUNC_map_lookup_elem));
  p.push_back(jmp64_imm(BPF_JEQ, 0, 0, 2));
  p.push_back(mov64_imm(1, 1));
  p.push_back(xadd_w(0, 1, 4));                // value.opens += 1
  p.push_back(mov64_imm(0, 1));
  p.push_back(exit_insn());
  // deny: bump the reserved deny counter {0,0,0}
  p.push_back(st_w_imm(10, kKeyOff, 0));
  p.push_back(st_w_imm(10, kKeyOff + 4, 0));
  p.push_back(st_w_imm(10, kKeyOff + 8, 0));
  p.push_back(bpf_insn{BPF_LD | BPF_IMM | BPF_DW, 1, BPF_PSEUDO_MAP_FD, 0,
                       map_fd});
  p.push_back(bpf_insn{0, 0, 0, 0, 0});
  p.push_back(mov64_reg(2, 10));
  p.push_back(add64_imm(2, kKeyOff));
  p.push_back(call_insn(BPF_FUNC_map_lookup_elem));
  p.push_back(jmp64_imm(BPF_JEQ, 0, 0, 2));
  p.push_back(mov64_imm(1, 1));
  p.push_back(xadd_w(0, 1, 4));
  p.push_back(mov64_imm(0, 0));
  p.push_back(exit_insn());
  return p;
}

// Map keys carry the ctx encoding of the device type (BPF_DEVCG_DEV_*),
// not the rule's ASCII letter — the program compares the raw ctx field.
uint32_t devcg_type(int32_t rule_type) {
  return rule_type == 'b' ? BPF_DEVCG_DEV_BLOCK : BPF_DEVCG_DEV_CHAR;
}

// Expand one DeviceRule into map upserts (type 'a' → char and block).
int map_put_rule(int map_fd, const DeviceRule& r) {
  uint32_t types[2];
  int n_types = 0;
  if (r.dev_type == 'a') {
    types[n_types++] = BPF_DEVCG_DEV_CHAR;
    types[n_types++] = BPF_DEVCG_DEV_BLOCK;
  } else {
    types[n_types++] = devcg_type(r.dev_type);
  }
  for (int t = 0; t < n_types; t++) {
    GateKey key{types[t],
                r.has_major ? static_cast<uint32_t>(r.major) : GATE_WILDCARD,
                r.has_minor ? static_cast<uint32_t>(r.minor) : GATE_WILDCARD};
    // preserve the open counter of a surviving key: merge, don't clobber
    GateVal val{static_cast<uint32_t>(r.access), 0};
    bpf_attr_map_elem look{};
    look.map_fd = static_cast<uint32_t>(map_fd);
    look.key = reinterpret_cast<uint64_t>(&key);
    GateVal old{};
    look.value = reinterpret_cast<uint64_t>(&old);
    if (sys_bpf(BPF_CMD_MAP_LOOKUP_ELEM, &look, sizeof(look)) == 0)
      val.opens = old.opens;
    bpf_attr_map_elem up{};
    up.map_fd = static_cast<uint32_t>(map_fd);
    up.key = reinterpret_cast<uint64_t>(&key);
    up.value = reinterpret_cast<uint64_t>(&val);
    up.flags = BPF_MAP_UPDATE_ANY;
    if (sys_bpf(BPF_CMD_MAP_UPDATE_ELEM, &up, sizeof(up)) < 0) return -errno;
  }
  return 0;
}

bool rule_covers_key(const DeviceRule* rules, int n_rules,
                     const GateKey& key) {
  for (int i = 0; i < n_rules; i++) {
    const DeviceRule& r = rules[i];
    uint32_t want_major =
        r.has_major ? static_cast<uint32_t>(r.major) : GATE_WILDCARD;
    uint32_t want_minor =
        r.has_minor ? static_cast<uint32_t>(r.minor) : GATE_WILDCARD;
    bool type_ok = (r.dev_type == 'a')
                       ? (key.dev_type == BPF_DEVCG_DEV_CHAR ||
                          key.dev_type == BPF_DEVCG_DEV_BLOCK)
                       : (key.dev_type == devcg_type(r.dev_type));
    if (type_ok && key.major == want_major && key.minor == want_minor)
      return true;
  }
  return false;
}

}  // namespace

extern "C" {

int bpfgate_map_sync(int map_fd, const DeviceRule* rules, int n_rules);

// Attach (or adopt) the map-driven gate on `cgroup_path` and seed/sync its
// policy map to `rules`. Outcomes:
//   1  attached fresh (replaced the runtime's program(s) with the map
//      program; *map_fd_out holds the live map's fd)
//   2  NOOP — no device program attached, access already unrestricted
//      (attaching ours would newly restrict the container; stay out)
//   3  adopted — a tpumounter map program was already attached (previous
//      worker incarnation); recovered its map fd, synced the rules
//   negative errno on failure.
int bpfgate_map_attach(const char* cgroup_path, const DeviceRule* rules,
                       int n_rules, int* map_fd_out) {
  if (!cgroup_path || !map_fd_out || (!rules && n_rules > 0)) return -EINVAL;
  *map_fd_out = -1;
  int cg_fd = open(cgroup_path, O_RDONLY | O_DIRECTORY);
  if (cg_fd < 0) return -errno;

  uint32_t prog_ids[16] = {0};
  bpf_attr_query q{};
  q.target_fd = static_cast<uint32_t>(cg_fd);
  q.attach_type = BPF_CGROUP_DEVICE;
  q.prog_ids = reinterpret_cast<uint64_t>(prog_ids);
  q.prog_cnt = 16;
  if (sys_bpf(BPF_CMD_PROG_QUERY, &q, sizeof(q)) < 0) {
    int e = errno;
    close(cg_fd);
    return -e;
  }
  if (q.prog_cnt == 0) {
    close(cg_fd);
    return 2;  // unrestricted cgroup: nothing to gate
  }

  // Adoption pass: is one of the attached programs already ours? (A
  // restarted worker must recover the live map, not replace it — the map
  // carries the open counters and the crash-surviving policy.)
  for (uint32_t i = 0; i < q.prog_cnt; i++) {
    bpf_attr_get_fd_by_id get{};
    get.id = prog_ids[i];
    long prog_fd = sys_bpf(BPF_CMD_PROG_GET_FD_BY_ID, &get, sizeof(get));
    if (prog_fd < 0) continue;
    uint32_t map_ids[4] = {0};
    bpf_prog_info_named info{};
    info.nr_map_ids = 4;
    info.map_ids = reinterpret_cast<uint64_t>(map_ids);
    bpf_attr_obj_info oi{};
    oi.bpf_fd = static_cast<uint32_t>(prog_fd);
    oi.info_len = sizeof(info);
    oi.info = reinterpret_cast<uint64_t>(&info);
    long rc = sys_bpf(BPF_CMD_OBJ_GET_INFO_BY_FD, &oi, sizeof(oi));
    close(static_cast<int>(prog_fd));
    if (rc < 0 || strncmp(info.name, kGateMapProgName, sizeof(info.name)))
      continue;
    if (info.nr_map_ids < 1) continue;
    bpf_attr_get_fd_by_id mget{};
    mget.id = map_ids[0];
    long map_fd = sys_bpf(BPF_CMD_MAP_GET_FD_BY_ID, &mget, sizeof(mget));
    if (map_fd < 0) continue;
    close(cg_fd);
    int sync_rc = bpfgate_map_sync(static_cast<int>(map_fd), rules, n_rules);
    if (sync_rc < 0) {
      close(static_cast<int>(map_fd));
      return sync_rc;
    }
    *map_fd_out = static_cast<int>(map_fd);
    return 3;
  }

  // Fresh attach: create + seed the map, load the map program, replace
  // every attached program with it (runc attaches exactly one).
  bpf_attr_map_create mc{};
  mc.map_type = BPF_MAP_TYPE_HASH;
  mc.key_size = sizeof(GateKey);
  mc.value_size = sizeof(GateVal);
  mc.max_entries = GATE_MAP_MAX_ENTRIES;
  snprintf(mc.map_name, sizeof(mc.map_name), "tpumtr_gate");
  long map_fd = sys_bpf(BPF_CMD_MAP_CREATE, &mc, sizeof(mc));
  if (map_fd < 0) {
    int e = errno;
    close(cg_fd);
    return -e;
  }
  int rc = bpfgate_map_sync(static_cast<int>(map_fd), rules, n_rules);
  if (rc < 0) {
    close(static_cast<int>(map_fd));
    close(cg_fd);
    return rc;
  }

  std::vector<bpf_insn> p = build_map_program(static_cast<int>(map_fd));
  bpf_attr_prog_load load{};
  load.prog_type = BPF_PROG_TYPE_CGROUP_DEVICE;
  load.insn_cnt = static_cast<uint32_t>(p.size());
  load.insns = reinterpret_cast<uint64_t>(p.data());
  static const char license[] = "Apache-2.0";
  load.license = reinterpret_cast<uint64_t>(license);
  load.expected_attach_type = BPF_CGROUP_DEVICE;
  snprintf(load.prog_name, sizeof(load.prog_name), "%s", kGateMapProgName);
  long new_fd = sys_bpf(BPF_CMD_PROG_LOAD, &load, sizeof(load));
  if (new_fd < 0) {
    int e = errno;
    close(static_cast<int>(map_fd));
    close(cg_fd);
    return -e;
  }
  rc = 1;
  for (uint32_t i = 0; i < q.prog_cnt; i++) {
    bpf_attr_get_fd_by_id get{};
    get.id = prog_ids[i];
    long old_fd = sys_bpf(BPF_CMD_PROG_GET_FD_BY_ID, &get, sizeof(get));
    if (old_fd < 0) {
      rc = -errno;
      break;
    }
    bpf_attr_attach att{};
    att.target_fd = static_cast<uint32_t>(cg_fd);
    att.attach_bpf_fd = static_cast<uint32_t>(new_fd);
    att.attach_type = BPF_CGROUP_DEVICE;
    att.attach_flags = q.attach_flags | BPF_F_REPLACE;
    att.replace_bpf_fd = static_cast<uint32_t>(old_fd);
    if (sys_bpf(BPF_CMD_PROG_ATTACH, &att, sizeof(att)) < 0) {
      bpf_attr_attach det{};
      det.target_fd = static_cast<uint32_t>(cg_fd);
      det.attach_bpf_fd = static_cast<uint32_t>(old_fd);
      det.attach_type = BPF_CGROUP_DEVICE;
      sys_bpf(BPF_CMD_PROG_DETACH, &det, sizeof(det));
      bpf_attr_attach att2{};
      att2.target_fd = static_cast<uint32_t>(cg_fd);
      att2.attach_bpf_fd = static_cast<uint32_t>(new_fd);
      att2.attach_type = BPF_CGROUP_DEVICE;
      att2.attach_flags = q.attach_flags & ~BPF_F_REPLACE;
      if (sys_bpf(BPF_CMD_PROG_ATTACH, &att2, sizeof(att2)) < 0) rc = -errno;
    }
    close(static_cast<int>(old_fd));
    if (rc < 0) break;
  }
  close(static_cast<int>(new_fd));
  close(cg_fd);
  if (rc < 0) {
    close(static_cast<int>(map_fd));
    return rc;
  }
  *map_fd_out = static_cast<int>(map_fd);
  return 1;
}

// Make the live map's policy match exactly `rules`: delete keys no rule
// covers (in-place revocation — this IS the revoke path), upsert the rest
// preserving surviving keys' open counters. The reserved deny-counter key
// {0,0,0} is created if missing and never deleted. Returns 1 or -errno.
int bpfgate_map_sync(int map_fd, const DeviceRule* rules, int n_rules) {
  if (map_fd < 0 || (!rules && n_rules > 0)) return -EINVAL;
  // sweep stale keys first: revocation must win over addition
  GateKey cur{}, next{};
  bool have = false;
  std::vector<GateKey> doomed;
  for (;;) {
    bpf_attr_map_elem gk{};
    gk.map_fd = static_cast<uint32_t>(map_fd);
    gk.key = have ? reinterpret_cast<uint64_t>(&cur) : 0;
    gk.value = reinterpret_cast<uint64_t>(&next);
    if (sys_bpf(BPF_CMD_MAP_GET_NEXT_KEY, &gk, sizeof(gk)) < 0) {
      if (errno == ENOENT) break;  // iteration done
      return -errno;
    }
    cur = next;
    have = true;
    if (cur.dev_type == 0) continue;  // reserved deny counter
    if (!rule_covers_key(rules, n_rules, cur)) doomed.push_back(cur);
  }
  for (GateKey& key : doomed) {
    bpf_attr_map_elem del{};
    del.map_fd = static_cast<uint32_t>(map_fd);
    del.key = reinterpret_cast<uint64_t>(&key);
    if (sys_bpf(BPF_CMD_MAP_DELETE_ELEM, &del, sizeof(del)) < 0 &&
        errno != ENOENT)
      return -errno;
  }
  for (int i = 0; i < n_rules; i++) {
    int rc = map_put_rule(map_fd, rules[i]);
    if (rc < 0) return rc;
  }
  // ensure the deny counter exists (never reset if it does)
  GateKey deny_key{0, 0, 0};
  GateVal deny_val{0, 0};
  bpf_attr_map_elem look{};
  look.map_fd = static_cast<uint32_t>(map_fd);
  look.key = reinterpret_cast<uint64_t>(&deny_key);
  look.value = reinterpret_cast<uint64_t>(&deny_val);
  if (sys_bpf(BPF_CMD_MAP_LOOKUP_ELEM, &look, sizeof(look)) < 0) {
    bpf_attr_map_elem up{};
    up.map_fd = static_cast<uint32_t>(map_fd);
    up.key = reinterpret_cast<uint64_t>(&deny_key);
    GateVal zero{0, 0};
    up.value = reinterpret_cast<uint64_t>(&zero);
    if (sys_bpf(BPF_CMD_MAP_UPDATE_ELEM, &up, sizeof(up)) < 0) return -errno;
  }
  return 1;
}

// Read back the live map: rules (the deny counter reported as dev_type 0)
// with per-key open counts in out_opens. Returns entry count or -errno
// (-E2BIG when out is too small).
int bpfgate_map_read(int map_fd, DeviceRule* out_rules, uint64_t* out_opens,
                     int max_entries) {
  if (map_fd < 0 || !out_rules || !out_opens) return -EINVAL;
  GateKey cur{}, next{};
  bool have = false;
  int n = 0;
  for (;;) {
    bpf_attr_map_elem gk{};
    gk.map_fd = static_cast<uint32_t>(map_fd);
    gk.key = have ? reinterpret_cast<uint64_t>(&cur) : 0;
    gk.value = reinterpret_cast<uint64_t>(&next);
    if (sys_bpf(BPF_CMD_MAP_GET_NEXT_KEY, &gk, sizeof(gk)) < 0) {
      if (errno == ENOENT) break;
      return -errno;
    }
    cur = next;
    have = true;
    GateVal val{};
    bpf_attr_map_elem look{};
    look.map_fd = static_cast<uint32_t>(map_fd);
    look.key = reinterpret_cast<uint64_t>(&cur);
    look.value = reinterpret_cast<uint64_t>(&val);
    if (sys_bpf(BPF_CMD_MAP_LOOKUP_ELEM, &look, sizeof(look)) < 0)
      continue;  // raced a delete
    if (n >= max_entries) return -E2BIG;
    // convert back to the rule ABI's ASCII letters (0 = the deny counter)
    out_rules[n].dev_type = cur.dev_type == BPF_DEVCG_DEV_CHAR   ? 'c'
                            : cur.dev_type == BPF_DEVCG_DEV_BLOCK ? 'b'
                                                                  : 0;
    out_rules[n].access = static_cast<int32_t>(val.access);
    out_rules[n].has_major = cur.major != GATE_WILDCARD;
    out_rules[n].has_minor = cur.minor != GATE_WILDCARD;
    out_rules[n].major =
        cur.major == GATE_WILDCARD ? 0 : static_cast<int32_t>(cur.major);
    out_rules[n].minor =
        cur.minor == GATE_WILDCARD ? 0 : static_cast<int32_t>(cur.minor);
    out_opens[n] = val.opens;
    n++;
  }
  return n;
}

int bpfgate_map_close(int map_fd) {
  if (map_fd < 0) return -EINVAL;
  return close(map_fd) == 0 ? 1 : -errno;
}

// Recover-ONLY adoption probe: if a tpumounter map program is attached to
// `cgroup_path`, hand back its live map fd WITHOUT touching the policy.
// This is what a freshly restarted worker's orphan discovery walks the
// kubepods cgroup subtree with — enumeration of crash-surviving gates the
// in-process fd cache cannot provide. Returns 3 adopted (fd in
// *map_fd_out), 2 no gate program here, negative errno.
int bpfgate_map_recover(const char* cgroup_path, int* map_fd_out) {
  if (!cgroup_path || !map_fd_out) return -EINVAL;
  *map_fd_out = -1;
  int cg_fd = open(cgroup_path, O_RDONLY | O_DIRECTORY);
  if (cg_fd < 0) return -errno;
  uint32_t prog_ids[16] = {0};
  bpf_attr_query q{};
  q.target_fd = static_cast<uint32_t>(cg_fd);
  q.attach_type = BPF_CGROUP_DEVICE;
  q.prog_ids = reinterpret_cast<uint64_t>(prog_ids);
  q.prog_cnt = 16;
  long qrc = sys_bpf(BPF_CMD_PROG_QUERY, &q, sizeof(q));
  close(cg_fd);
  if (qrc < 0) return -errno;
  for (uint32_t i = 0; i < q.prog_cnt; i++) {
    bpf_attr_get_fd_by_id get{};
    get.id = prog_ids[i];
    long prog_fd = sys_bpf(BPF_CMD_PROG_GET_FD_BY_ID, &get, sizeof(get));
    if (prog_fd < 0) continue;
    uint32_t map_ids[4] = {0};
    bpf_prog_info_named info{};
    info.nr_map_ids = 4;
    info.map_ids = reinterpret_cast<uint64_t>(map_ids);
    bpf_attr_obj_info oi{};
    oi.bpf_fd = static_cast<uint32_t>(prog_fd);
    oi.info_len = sizeof(info);
    oi.info = reinterpret_cast<uint64_t>(&info);
    long rc = sys_bpf(BPF_CMD_OBJ_GET_INFO_BY_FD, &oi, sizeof(oi));
    close(static_cast<int>(prog_fd));
    if (rc < 0 || strncmp(info.name, kGateMapProgName, sizeof(info.name)))
      continue;
    if (info.nr_map_ids < 1) continue;
    bpf_attr_get_fd_by_id mget{};
    mget.id = map_ids[0];
    long map_fd = sys_bpf(BPF_CMD_MAP_GET_FD_BY_ID, &mget, sizeof(mget));
    if (map_fd < 0) continue;
    *map_fd_out = static_cast<int>(map_fd);
    return 3;
  }
  return 2;
}

// Pure codegen of the map program (no privileges; map_fd is only embedded
// in the ld_imm64) — exposed so tests can pin the instruction stream.
int bpfgate_build_map_program(int map_fd, bpf_insn* out, int max_insns) {
  if (!out) return -1;
  std::vector<bpf_insn> p = build_map_program(map_fd);
  if (static_cast<int>(p.size()) > max_insns) return -1;
  memcpy(out, p.data(), p.size() * sizeof(bpf_insn));
  return static_cast<int>(p.size());
}

// Pure codegen (no privileges): emit program into out (cap max_insns).
// Returns instruction count, or -1 if out is too small / args invalid.
int bpfgate_build_program(const DeviceRule* rules, int n_rules, bpf_insn* out,
                          int max_insns) {
  if ((!rules && n_rules > 0) || !out) return -1;
  std::vector<bpf_insn> p = build_program(rules, n_rules);
  if (static_cast<int>(p.size()) > max_insns) return -1;
  memcpy(out, p.data(), p.size() * sizeof(bpf_insn));
  return static_cast<int>(p.size());
}

// Probe whether this kernel+caller can load cgroup-device programs.
// Returns 1 yes, 0 no-permission, negative errno on other failures.
int bpfgate_supported(void) {
  DeviceRule none{};
  std::vector<bpf_insn> p = build_program(&none, 0);
  bpf_attr_prog_load attr{};
  attr.prog_type = BPF_PROG_TYPE_CGROUP_DEVICE;
  attr.insn_cnt = static_cast<uint32_t>(p.size());
  attr.insns = reinterpret_cast<uint64_t>(p.data());
  static const char license[] = "Apache-2.0";
  attr.license = reinterpret_cast<uint64_t>(license);
  attr.expected_attach_type = BPF_CGROUP_DEVICE;
  long fd = sys_bpf(BPF_CMD_PROG_LOAD, &attr, sizeof(attr));
  if (fd >= 0) {
    close(static_cast<int>(fd));
    return 1;
  }
  if (errno == EPERM || errno == EACCES) return 0;
  return -errno;
}

// Make `cgroup_path`'s device program match exactly `rules`:
//  - 0 programs attached  -> nothing to do (access already unrestricted),
//    returns 2 (NOOP).
//  - >=1 attached         -> load new program and atomically BPF_F_REPLACE
//    each attached program (in practice runc attaches exactly one).
// Returns 1 on success, 2 NOOP, negative errno on failure.
int bpfgate_sync(const char* cgroup_path, const DeviceRule* rules,
                 int n_rules) {
  if (!cgroup_path) return -EINVAL;
  int cg_fd = open(cgroup_path, O_RDONLY | O_DIRECTORY);
  if (cg_fd < 0) return -errno;

  uint32_t prog_ids[16] = {0};
  bpf_attr_query q{};
  q.target_fd = static_cast<uint32_t>(cg_fd);
  q.attach_type = BPF_CGROUP_DEVICE;
  q.prog_ids = reinterpret_cast<uint64_t>(prog_ids);
  q.prog_cnt = 16;
  if (sys_bpf(BPF_CMD_PROG_QUERY, &q, sizeof(q)) < 0) {
    int e = errno;
    close(cg_fd);
    return -e;
  }
  if (q.prog_cnt == 0) {
    close(cg_fd);
    return 2;  // no device gating in force; nothing to extend
  }

  std::vector<bpf_insn> p = build_program(rules, n_rules);
  bpf_attr_prog_load load{};
  load.prog_type = BPF_PROG_TYPE_CGROUP_DEVICE;
  load.insn_cnt = static_cast<uint32_t>(p.size());
  load.insns = reinterpret_cast<uint64_t>(p.data());
  static const char license[] = "Apache-2.0";
  load.license = reinterpret_cast<uint64_t>(license);
  load.expected_attach_type = BPF_CGROUP_DEVICE;
  snprintf(load.prog_name, sizeof(load.prog_name), "tpumounter_dev");
  long new_fd = sys_bpf(BPF_CMD_PROG_LOAD, &load, sizeof(load));
  if (new_fd < 0) {
    int e = errno;
    close(cg_fd);
    return -e;
  }

  int rc = 1;
  for (uint32_t i = 0; i < q.prog_cnt; i++) {
    bpf_attr_get_fd_by_id get{};
    get.id = prog_ids[i];
    long old_fd = sys_bpf(BPF_CMD_PROG_GET_FD_BY_ID, &get, sizeof(get));
    if (old_fd < 0) {
      rc = -errno;
      break;
    }
    bpf_attr_attach att{};
    att.target_fd = static_cast<uint32_t>(cg_fd);
    att.attach_bpf_fd = static_cast<uint32_t>(new_fd);
    att.attach_type = BPF_CGROUP_DEVICE;
    att.attach_flags = q.attach_flags | BPF_F_REPLACE;
    att.replace_bpf_fd = static_cast<uint32_t>(old_fd);
    if (sys_bpf(BPF_CMD_PROG_ATTACH, &att, sizeof(att)) < 0) {
      // kernels without BPF_F_REPLACE for this type: detach+attach fallback
      bpf_attr_attach det{};
      det.target_fd = static_cast<uint32_t>(cg_fd);
      det.attach_bpf_fd = static_cast<uint32_t>(old_fd);
      det.attach_type = BPF_CGROUP_DEVICE;
      sys_bpf(BPF_CMD_PROG_DETACH, &det, sizeof(det));
      bpf_attr_attach att2{};
      att2.target_fd = static_cast<uint32_t>(cg_fd);
      att2.attach_bpf_fd = static_cast<uint32_t>(new_fd);
      att2.attach_type = BPF_CGROUP_DEVICE;
      att2.attach_flags = q.attach_flags & ~BPF_F_REPLACE;
      if (sys_bpf(BPF_CMD_PROG_ATTACH, &att2, sizeof(att2)) < 0) rc = -errno;
    }
    close(static_cast<int>(old_fd));
    if (rc < 0) break;
  }
  close(static_cast<int>(new_fd));
  close(cg_fd);
  return rc;
}

// Number of device programs attached to the cgroup, or negative errno.
int bpfgate_attached_count(const char* cgroup_path) {
  if (!cgroup_path) return -EINVAL;
  int cg_fd = open(cgroup_path, O_RDONLY | O_DIRECTORY);
  if (cg_fd < 0) return -errno;
  bpf_attr_query q{};
  q.target_fd = static_cast<uint32_t>(cg_fd);
  q.attach_type = BPF_CGROUP_DEVICE;
  q.prog_cnt = 0;  // count-only query
  long rc = sys_bpf(BPF_CMD_PROG_QUERY, &q, sizeof(q));
  int e = errno;
  close(cg_fd);
  if (rc < 0 && e != ENOSPC) return -e;
  return static_cast<int>(q.prog_cnt);
}

// Read back the xlated instructions of attached program `index` on the
// cgroup. CGROUP_DEVICE programs have no ctx-access rewriting, so the
// xlated stream is directly interpretable (used for preservation checks and
// the kernel-proven tests). Returns instruction count, or negative errno
// (-ENOENT when index is out of range, -E2BIG when out is too small).
// Requires CAP_SYS_ADMIN/CAP_PERFMON for xlated visibility.
int bpfgate_read_attached(const char* cgroup_path, int index, bpf_insn* out,
                          int max_insns) {
  if (!cgroup_path || !out || index < 0) return -EINVAL;
  int cg_fd = open(cgroup_path, O_RDONLY | O_DIRECTORY);
  if (cg_fd < 0) return -errno;

  uint32_t prog_ids[16] = {0};
  bpf_attr_query q{};
  q.target_fd = static_cast<uint32_t>(cg_fd);
  q.attach_type = BPF_CGROUP_DEVICE;
  q.prog_ids = reinterpret_cast<uint64_t>(prog_ids);
  q.prog_cnt = 16;
  if (sys_bpf(BPF_CMD_PROG_QUERY, &q, sizeof(q)) < 0) {
    int e = errno;
    close(cg_fd);
    return -e;
  }
  close(cg_fd);
  if (static_cast<uint32_t>(index) >= q.prog_cnt) return -ENOENT;

  bpf_attr_get_fd_by_id get{};
  get.id = prog_ids[index];
  long prog_fd = sys_bpf(BPF_CMD_PROG_GET_FD_BY_ID, &get, sizeof(get));
  if (prog_fd < 0) return -errno;

  bpf_prog_info_min info{};
  bpf_attr_obj_info oi{};
  oi.bpf_fd = static_cast<uint32_t>(prog_fd);
  oi.info_len = sizeof(info);
  oi.info = reinterpret_cast<uint64_t>(&info);
  if (sys_bpf(BPF_CMD_OBJ_GET_INFO_BY_FD, &oi, sizeof(oi)) < 0) {
    int e = errno;
    close(static_cast<int>(prog_fd));
    return -e;
  }
  int n = static_cast<int>(info.xlated_prog_len / sizeof(bpf_insn));
  if (n > max_insns) {
    close(static_cast<int>(prog_fd));
    return -E2BIG;
  }
  std::vector<bpf_insn> buf(n);
  bpf_prog_info_min info2{};
  info2.xlated_prog_len = static_cast<uint32_t>(n * sizeof(bpf_insn));
  info2.xlated_prog_insns = reinterpret_cast<uint64_t>(buf.data());
  oi.info_len = sizeof(info2);
  oi.info = reinterpret_cast<uint64_t>(&info2);
  if (sys_bpf(BPF_CMD_OBJ_GET_INFO_BY_FD, &oi, sizeof(oi)) < 0) {
    int e = errno;
    close(static_cast<int>(prog_fd));
    return -e;
  }
  close(static_cast<int>(prog_fd));
  n = static_cast<int>(info2.xlated_prog_len / sizeof(bpf_insn));
  memcpy(out, buf.data(), n * sizeof(bpf_insn));
  return n;
}

// Attach a fresh allowlist program the way a container runtime would
// (BPF_F_ALLOW_MULTI, no replace). Used by the kernel-proven tests to stand
// up a "runc-attached" baseline on a scratch cgroup; production code only
// ever replaces via bpfgate_sync. Returns 1 or negative errno.
int bpfgate_attach(const char* cgroup_path, const DeviceRule* rules,
                   int n_rules) {
  if (!cgroup_path || (!rules && n_rules > 0)) return -EINVAL;
  int cg_fd = open(cgroup_path, O_RDONLY | O_DIRECTORY);
  if (cg_fd < 0) return -errno;
  std::vector<bpf_insn> p = build_program(rules, n_rules);
  bpf_attr_prog_load load{};
  load.prog_type = BPF_PROG_TYPE_CGROUP_DEVICE;
  load.insn_cnt = static_cast<uint32_t>(p.size());
  load.insns = reinterpret_cast<uint64_t>(p.data());
  static const char license[] = "Apache-2.0";
  load.license = reinterpret_cast<uint64_t>(license);
  load.expected_attach_type = BPF_CGROUP_DEVICE;
  snprintf(load.prog_name, sizeof(load.prog_name), "runtime_dev");
  long prog_fd = sys_bpf(BPF_CMD_PROG_LOAD, &load, sizeof(load));
  if (prog_fd < 0) {
    int e = errno;
    close(cg_fd);
    return -e;
  }
  bpf_attr_attach att{};
  att.target_fd = static_cast<uint32_t>(cg_fd);
  att.attach_bpf_fd = static_cast<uint32_t>(prog_fd);
  att.attach_type = BPF_CGROUP_DEVICE;
  att.attach_flags = BPF_F_ALLOW_MULTI;
  int rc = 1;
  if (sys_bpf(BPF_CMD_PROG_ATTACH, &att, sizeof(att)) < 0) rc = -errno;
  close(static_cast<int>(prog_fd));
  close(cg_fd);
  return rc;
}

int bpfgate_abi_version(void) { return 3; }

}  // extern "C"
