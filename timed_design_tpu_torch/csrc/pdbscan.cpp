// Fast PDB record scanner (native data-loader component).
//
// The port's copy of native/pdbscan.cpp, unchanged but for this note: the
// hot host-side loop of PDB ingestion — fixed-column field extraction from
// ATOM/HETATM records — runs in C++ instead of per-line Python string
// slicing. Exposed as a C ABI for ctypes; the Python side
// (timed_design_tpu_torch/structure/_native.py) owns the output buffers,
// builds this file into timed_design_tpu_torch/_build/, and keeps the
// residue-grouping logic in vectorized NumPy.
//
// Build: g++ -O3 -shared -fPIC -o libpdbscan.so pdbscan.cpp
#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

inline bool parse_float(const char* s, int width, float* out) {
    // strtof on a bounded, possibly space-padded fixed column; false when
    // the field contains no numeric value (malformed record -> skip)
    char buf[16];
    int n = width < 15 ? width : 15;
    std::memcpy(buf, s, n);
    buf[n] = '\0';
    char* end = nullptr;
    *out = std::strtof(buf, &end);
    if (end == buf) return false;
    while (*end == ' ') ++end;  // python float() semantics: whole field
    return *end == '\0';
}

inline bool parse_int(const char* s, int width, int* out) {
    char buf[16];
    int n = width < 15 ? width : 15;
    std::memcpy(buf, s, n);
    buf[n] = '\0';
    char* end = nullptr;
    *out = static_cast<int>(std::strtol(buf, &end, 10));
    if (end == buf) return false;
    while (*end == ' ') ++end;  // python int() semantics: whole field
    return *end == '\0';
}

inline void copy_trim(const char* src, int width, char* dst, int cap) {
    int start = 0, end = width;
    while (start < end && src[start] == ' ') ++start;
    while (end > start && src[end - 1] == ' ') --end;
    int n = end - start;
    if (n > cap) n = cap;
    std::memcpy(dst, src + start, n);
    for (int i = n; i < cap; ++i) dst[i] = '\0';
}

}  // namespace

extern "C" {

// Scans `text` (len bytes) for ATOM/HETATM records up to `cap` atoms.
// MODEL/ENDMDL boundaries increment the model index. Outputs are parallel
// arrays (caller-allocated, cap entries each):
//   coords:     float32 (cap, 3)
//   bfactors:   float32 (cap,)
//   res_seq:    int32   (cap,)
//   model_idx:  int32   (cap,)
//   atom_name:  char    (cap, 4)   NUL-padded
//   res_name:   char    (cap, 3)
//   element:    char    (cap, 2)
//   chain_id:   char    (cap,)
//   icode:      char    (cap,)
//   altloc:     char    (cap,)
//   is_het:     uint8   (cap,)
// Returns the number of atoms written (or -1 if cap exceeded).
long pdb_scan(const char* text, long len, long cap,
              float* coords, float* bfactors,
              int32_t* res_seq, int32_t* model_idx,
              char* atom_name, char* res_name, char* element,
              char* chain_id, char* icode, char* altloc,
              uint8_t* is_het) {
    long count = 0;
    int32_t model = 0;
    bool model_has_atoms = false;
    const char* p = text;
    const char* end = text + len;
    while (p < end) {
        const char* nl = static_cast<const char*>(std::memchr(p, '\n', end - p));
        long line_len = nl ? nl - p : end - p;
        if (line_len >= 6) {
            bool atom = std::memcmp(p, "ATOM  ", 6) == 0;
            bool het = !atom && std::memcmp(p, "HETATM", 6) == 0;
            if ((atom || het) && line_len >= 54) {
                if (count >= cap) return -1;
                int seq;
                float x, y, z;
                bool ok = parse_int(p + 22, 4, &seq)
                    && parse_float(p + 30, 8, &x)
                    && parse_float(p + 38, 8, &y)
                    && parse_float(p + 46, 8, &z);
                if (!ok) { if (nl) { p = nl + 1; continue; } else break; }
                copy_trim(p + 12, 4, atom_name + count * 4, 4);
                altloc[count] = p[16];
                copy_trim(p + 17, 3, res_name + count * 3, 3);
                chain_id[count] = p[21];
                res_seq[count] = seq;
                icode[count] = p[26] == ' ' ? '\0' : p[26];
                coords[count * 3 + 0] = x;
                coords[count * 3 + 1] = y;
                coords[count * 3 + 2] = z;
                float bf = 0.0f;
                // python-parity: float(line[60:66]) also parses short slices
                // of truncated lines (width = what's available past col 60)
                if (line_len > 60) {
                    int w = line_len - 60 < 6 ? (int)(line_len - 60) : 6;
                    if (!parse_float(p + 60, w, &bf)) bf = 0.0f;
                }
                bfactors[count] = bf;
                if (line_len >= 78) {
                    copy_trim(p + 76, 2, element + count * 2, 2);
                } else {
                    element[count * 2] = '\0';
                    element[count * 2 + 1] = '\0';
                }
                model_idx[count] = model;
                is_het[count] = het ? 1 : 0;
                ++count;
                model_has_atoms = true;
            } else if (line_len >= 6 && std::memcmp(p, "MODEL ", 6) == 0) {
                if (model_has_atoms) { ++model; model_has_atoms = false; }
            } else if (std::memcmp(p, "ENDMDL", 6) == 0) {
                ++model;
                model_has_atoms = false;
            }
        }
        if (!nl) break;
        p = nl + 1;
    }
    return count;
}

}  // extern "C"
