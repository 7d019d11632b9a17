// hbird_native: host-side native code of the PyTorch Hummingbird port (a
// copy of the JAX package's native/hbird_native.cpp, entry points unchanged).
//
// The reference delegates all native work to third-party libraries (Faiss,
// ScaNN, scipy, PIL, tarfile-in-Python). This library covers two host
// runtime pieces:
//
//   1. hbird_tar_index  — single-pass ustar/GNU/PAX tar header scan with a
//      per-member callback (name, payload offset, size). Replaces Python
//      tarfile's header walk (reference hbird/data/voc/voc_tar_data.py:195-207),
//      which is interpreter-bound on 100k+-member COCO archives; member
//      payloads are then read with pread(2) at the recorded offsets, so the
//      data loader never re-parses headers.
//
//   2. hbird_hungarian   — Jonker-Volgenant shortest-augmenting-path solver
//      for the class-matching assignment (scipy linear_sum_assignment
//      equivalent; reference hbird/utils/eval_metrics.py:143-159).
//
// Built at first use with g++ -O3 -shared -fPIC into build/hbird_tpu_torch/
// and loaded via ctypes (hbird_tpu_torch/utils/native.py). A .tar read that
// cannot build or load it raises; nothing falls back silently.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Tar indexing
// ---------------------------------------------------------------------------

typedef void (*tar_member_cb)(const char *name, int64_t offset, int64_t size,
                              char typeflag, void *user);

static int64_t parse_octal(const char *p, size_t n) {
  // GNU base-256 extension: high bit of first byte set.
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    int64_t v = static_cast<unsigned char>(p[0]) & 0x7f;
    for (size_t i = 1; i < n; ++i)
      v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  int64_t v = 0;
  for (size_t i = 0; i < n; ++i) {
    char c = p[i];
    if (c == ' ' || c == '\0') {
      if (v) break;
      continue;
    }
    if (c < '0' || c > '7') break;
    v = (v << 3) + (c - '0');
  }
  return v;
}

// Extract "path=" from a PAX extended header payload.
static std::string pax_path(const char *buf, int64_t size) {
  const char *p = buf, *end = buf + size;
  while (p < end) {
    // each record: "<len> <key>=<value>\n"
    char *after = nullptr;
    long rec_len = strtol(p, &after, 10);
    if (rec_len <= 0 || after == nullptr || after >= end) break;
    const char *rec_end = p + rec_len;
    if (rec_end > end) break;
    const char *kv = after + 1;  // skip the space
    const char *eq = static_cast<const char *>(memchr(kv, '=', rec_end - kv));
    if (eq) {
      std::string key(kv, eq - kv);
      if (key == "path")
        return std::string(eq + 1, rec_end - 1 - (eq + 1));  // strip '\n'
    }
    p = rec_end;
  }
  return std::string();
}

// Scan the tar at `path`, firing `cb` for every member. Returns the member
// count, or -1 on I/O error, -2 on a malformed header.
int64_t hbird_tar_index(const char *path, tar_member_cb cb, void *user) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  char header[512];
  std::string longname;
  std::string paxname;
  int64_t count = 0;
  int zero_blocks = 0;

  while (fread(header, 1, 512, f) == 512) {
    bool all_zero = true;
    for (int i = 0; i < 512; ++i)
      if (header[i]) {
        all_zero = false;
        break;
      }
    if (all_zero) {
      if (++zero_blocks >= 2) break;
      continue;
    }
    zero_blocks = 0;

    int64_t size = parse_octal(header + 124, 12);
    char typeflag = header[156];
    int64_t payload = ftell(f);
    int64_t padded = (size + 511) & ~511LL;

    if (typeflag == 'L') {  // GNU longname: payload is the next member's name
      std::vector<char> buf(size + 1, 0);
      if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        fclose(f);
        return -2;
      }
      longname.assign(buf.data(), strnlen(buf.data(), size));
      fseek(f, payload + padded, SEEK_SET);
      continue;
    }
    if (typeflag == 'x' || typeflag == 'g') {  // PAX extended header
      std::vector<char> buf(size);
      if (size > 0 && fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        fclose(f);
        return -2;
      }
      if (typeflag == 'x') paxname = pax_path(buf.data(), size);
      fseek(f, payload + padded, SEEK_SET);
      continue;
    }

    std::string name;
    if (!paxname.empty()) {
      name.swap(paxname);
    } else if (!longname.empty()) {
      name.swap(longname);
    } else {
      char prefix[156] = {0};
      memcpy(prefix, header + 345, 155);
      char shortname[101] = {0};
      memcpy(shortname, header, 100);
      if (prefix[0])
        name = std::string(prefix) + "/" + shortname;
      else
        name = shortname;
    }

    // '0' and '\0' are regular files; report everything, caller filters.
    cb(name.c_str(), payload, size, typeflag ? typeflag : '0', user);
    ++count;
    fseek(f, payload + padded, SEEK_SET);
  }
  fclose(f);
  return count;
}

// ---------------------------------------------------------------------------
// Hungarian (Jonker-Volgenant shortest augmenting path)
// ---------------------------------------------------------------------------

// Solves min-cost assignment for an r x c cost matrix (row-major). Writes
// min(r, c) pairs into row_ind/col_ind (sorted by row). Returns the number
// of pairs, or -1 on allocation failure.
int hbird_hungarian(const double *cost, int n_rows, int n_cols, int64_t *row_ind,
                    int64_t *col_ind) {
  const bool transposed = n_rows > n_cols;
  const int r = transposed ? n_cols : n_rows;
  const int c = transposed ? n_rows : n_cols;
  const double INF = 1e300;

  std::vector<double> u(r + 1, 0.0), v(c + 1, 0.0);
  std::vector<int> match(c + 1, -1);

  auto C = [&](int i, int j) -> double {
    return transposed ? cost[(int64_t)j * n_cols + i]
                      : cost[(int64_t)i * n_cols + j];
  };

  std::vector<double> min_to(c + 1);
  std::vector<int> prev(c + 1);
  std::vector<char> used(c + 1);

  for (int cur_row = 0; cur_row < r; ++cur_row) {
    int j_cur = c;
    match[j_cur] = cur_row;
    std::fill(min_to.begin(), min_to.end(), INF);
    std::fill(prev.begin(), prev.end(), -1);
    std::fill(used.begin(), used.end(), 0);

    while (match[j_cur] != -1) {
      used[j_cur] = 1;
      int i = match[j_cur];
      double delta = INF;
      int j_next = -1;
      for (int j = 0; j < c; ++j) {
        if (used[j]) continue;
        double cur = C(i, j) - u[i] - v[j];
        if (cur < min_to[j]) {
          min_to[j] = cur;
          prev[j] = j_cur;
        }
        if (min_to[j] < delta) {
          delta = min_to[j];
          j_next = j;
        }
      }
      if (j_next == -1) break;  // defensive: disconnected (infinite costs)
      for (int j = 0; j <= c; ++j) {
        if (used[j]) {
          u[match[j]] += delta;
          v[j] -= delta;
        } else {
          min_to[j] -= delta;
        }
      }
      j_cur = j_next;
    }
    while (j_cur != c) {
      int j_prev = prev[j_cur];
      match[j_cur] = match[j_prev];
      j_cur = j_prev;
    }
  }

  int n_out = 0;
  for (int j = 0; j < c; ++j) {
    if (match[j] >= 0) {
      int i = match[j];
      if (transposed) {
        row_ind[n_out] = j;
        col_ind[n_out] = i;
      } else {
        row_ind[n_out] = i;
        col_ind[n_out] = j;
      }
      ++n_out;
    }
  }
  // sort by row (simple insertion sort; n <= a few hundred)
  for (int a = 1; a < n_out; ++a) {
    int64_t ri = row_ind[a], ci = col_ind[a];
    int b = a - 1;
    while (b >= 0 && row_ind[b] > ri) {
      row_ind[b + 1] = row_ind[b];
      col_ind[b + 1] = col_ind[b];
      --b;
    }
    row_ind[b + 1] = ri;
    col_ind[b + 1] = ci;
  }
  return n_out;
}

}  // extern "C"
