// tiffturbo: native TIFF block codec for proteus_jax.
//
// The reference delegates all raster compression to the GDAL C++ library
// (core.py:57-74); this is our native equivalent: multithreaded
// DEFLATE tile compression with TIFF predictors applied in place, fast
// DEFLATE/LZW decode, and predictor inversion. Exposed through a plain C
// ABI for ctypes (no pybind11 in this environment).
//
// Build: python -m proteus_jax.native.build

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <atomic>

#ifdef TT_USE_LIBDEFLATE
#include <libdeflate.h>
#else
#include <zlib.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// predictors
// ---------------------------------------------------------------------

// TIFF predictor 2 (horizontal differencing), in place.
// data: rows x cols x samples elements of itemsize bytes (native LE).
static void predict_h_row(uint8_t* row, int cols, int samples,
                          int itemsize) {
  const int last = cols * samples - 1;
  if (itemsize == 1) {
    for (int j = last; j >= samples; --j)
      row[j] = (uint8_t)(row[j] - row[j - samples]);
  } else if (itemsize == 2) {
    uint16_t* r = (uint16_t*)row;
    for (int j = last; j >= samples; --j)
      r[j] = (uint16_t)(r[j] - r[j - samples]);
  } else if (itemsize == 4) {
    uint32_t* r = (uint32_t*)row;
    for (int j = last; j >= samples; --j)
      r[j] = (uint32_t)(r[j] - r[j - samples]);
  }
}

static void unpredict_h_row(uint8_t* row, int cols, int samples,
                            int itemsize) {
  if (itemsize == 1) {
    for (int j = samples; j < cols * samples; ++j)
      row[j] = (uint8_t)(row[j] + row[j - samples]);
  } else if (itemsize == 2) {
    uint16_t* r = (uint16_t*)row;
    for (int j = samples; j < cols * samples; ++j)
      r[j] = (uint16_t)(r[j] + r[j - samples]);
  } else if (itemsize == 4) {
    uint32_t* r = (uint32_t*)row;
    for (int j = samples; j < cols * samples; ++j)
      r[j] = (uint32_t)(r[j] + r[j - samples]);
  }
}

// single-sample specialization, 4 rows interleaved: each row's running
// sum is an independent dependency chain, so interleaving lets the CPU
// pipeline them (the scalar one-row loop is issue-bound, not
// memory-bound — measured ~3x on the ingest unpredict stage).
// Macro-instantiated per element type (templates cannot carry C
// linkage and this file is one extern "C" block).
#define TT_DEFINE_UNPREDICT_INTERLEAVED(T)                                 \
  static void unpredict_h_rows4_##T(T* r0, T* r1, T* r2, T* r3,           \
                                    int cols) {                           \
    T a0 = r0[0], a1 = r1[0], a2 = r2[0], a3 = r3[0];                     \
    for (int j = 1; j < cols; ++j) {                                      \
      a0 = (T)(a0 + r0[j]); r0[j] = a0;                                   \
      a1 = (T)(a1 + r1[j]); r1[j] = a1;                                   \
      a2 = (T)(a2 + r2[j]); r2[j] = a2;                                   \
      a3 = (T)(a3 + r3[j]); r3[j] = a3;                                   \
    }                                                                     \
  }                                                                       \
  static void unpredict_h_interleaved_##T(uint8_t* data, int rows,        \
                                          int cols) {                     \
    const long row_bytes = (long)cols * sizeof(T);                        \
    int i = 0;                                                            \
    for (; i + 3 < rows; i += 4)                                          \
      unpredict_h_rows4_##T((T*)(data + (long)i * row_bytes),             \
                            (T*)(data + (long)(i + 1) * row_bytes),       \
                            (T*)(data + (long)(i + 2) * row_bytes),       \
                            (T*)(data + (long)(i + 3) * row_bytes),       \
                            cols);                                        \
    for (; i < rows; ++i)                                                 \
      unpredict_h_row(data + (long)i * row_bytes, cols, 1, sizeof(T));    \
  }

TT_DEFINE_UNPREDICT_INTERLEAVED(uint8_t)
TT_DEFINE_UNPREDICT_INTERLEAVED(uint16_t)
TT_DEFINE_UNPREDICT_INTERLEAVED(uint32_t)

void tt_predict_h(uint8_t* data, int rows, int cols, int samples,
                  int itemsize) {
  const long row_bytes = (long)cols * samples * itemsize;
  for (int i = 0; i < rows; ++i)
    predict_h_row(data + i * row_bytes, cols, samples, itemsize);
}

void tt_unpredict_h(uint8_t* data, int rows, int cols, int samples,
                    int itemsize) {
  if (samples == 1 && rows >= 4) {
    if (itemsize == 1)
      return unpredict_h_interleaved_uint8_t(data, rows, cols);
    if (itemsize == 2)
      return unpredict_h_interleaved_uint16_t(data, rows, cols);
    if (itemsize == 4)
      return unpredict_h_interleaved_uint32_t(data, rows, cols);
  }
  const long row_bytes = (long)cols * samples * itemsize;
  for (int i = 0; i < rows; ++i)
    unpredict_h_row(data + i * row_bytes, cols, samples, itemsize);
}

// ---------------------------------------------------------------------
// fused HLS band finalize: invalid-mask accumulate + negative clip
// ---------------------------------------------------------------------

// One pass over an int16 band doing what the ingest layer otherwise does
// in three full NumPy passes (io/hls.py::load_hls_band — matching the
// reference's fill-mask accumulation at dswx_hls.py:2201-2209 and the
// FLAG_CLIP_NEGATIVE_REFLECTANCE clip at :2298):
//   invalid[i] |= (band[i] == fill)
//   if (do_clip) band[i] = max(band[i], 1)   [in place]
void tt_band_finalize_i16(int16_t* band, int64_t n, int16_t fill,
                          int do_clip, uint8_t* invalid) {
  if (do_clip) {
    for (int64_t i = 0; i < n; ++i) {
      const int16_t v = band[i];
      invalid[i] |= (v == fill);
      band[i] = v < 1 ? 1 : v;
    }
  } else {
    for (int64_t i = 0; i < n; ++i)
      invalid[i] |= (band[i] == fill);
  }
}

// TIFF predictor 3 (floating-point): split bytes big-endian
// significance-major per row, then byte-difference. In/out buffers are
// separate (row_bytes scratch avoided by caller passing out).
void tt_predict_float(const uint8_t* in, uint8_t* out, int rows, int cols,
                      int samples, int itemsize) {
  const long n = (long)cols * samples;        // values per row
  const long row_bytes = n * itemsize;
  std::vector<uint8_t> tmp(row_bytes);
  for (int i = 0; i < rows; ++i) {
    const uint8_t* src = in + i * row_bytes;
    // split: byte k (big-endian significance) of all values first.
    // native little-endian value bytes are reversed: BE byte k = LE byte
    // itemsize-1-k
    for (int k = 0; k < itemsize; ++k) {
      uint8_t* dst = tmp.data() + (long)k * n;
      const int le = itemsize - 1 - k;
      for (long v = 0; v < n; ++v) dst[v] = src[v * itemsize + le];
    }
    uint8_t* orow = out + i * row_bytes;
    uint8_t prev = 0;
    for (long b = 0; b < row_bytes; ++b) {
      uint8_t cur = tmp[b];
      orow[b] = (uint8_t)(cur - prev);
      prev = cur;
    }
  }
}

void tt_unpredict_float(const uint8_t* in, uint8_t* out, int rows,
                        int cols, int samples, int itemsize) {
  const long n = (long)cols * samples;
  const long row_bytes = n * itemsize;
  std::vector<uint8_t> tmp(row_bytes);
  for (int i = 0; i < rows; ++i) {
    const uint8_t* src = in + i * row_bytes;
    uint8_t acc = 0;
    for (long b = 0; b < row_bytes; ++b) {
      acc = (uint8_t)(acc + src[b]);
      tmp[b] = acc;
    }
    uint8_t* orow = out + i * row_bytes;
    for (int k = 0; k < itemsize; ++k) {
      const uint8_t* plane = tmp.data() + (long)k * n;
      const int le = itemsize - 1 - k;
      for (long v = 0; v < n; ++v) orow[v * itemsize + le] = plane[v];
    }
  }
}

// ---------------------------------------------------------------------
// DEFLATE
// ---------------------------------------------------------------------

#ifdef TT_USE_LIBDEFLATE

// libdeflate is 5-25x faster than zlib on post-predictor raster tiles in
// both directions; output stays standard zlib-format DEFLATE.

long tt_deflate(const uint8_t* src, long src_len, int level, uint8_t* dst,
                long dst_cap) {
  if (level < 1) level = 1;
  if (level > 12) level = 12;
  struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
  if (!c) return -1;
  size_t n = libdeflate_zlib_compress(c, src, (size_t)src_len, dst,
                                      (size_t)dst_cap);
  libdeflate_free_compressor(c);
  return n == 0 ? -1 : (long)n;
}

long tt_inflate(const uint8_t* src, long src_len, uint8_t* dst,
                long dst_cap) {
  struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
  if (!d) return -1;
  size_t actual = 0;
  enum libdeflate_result rc = libdeflate_zlib_decompress(
      d, src, (size_t)src_len, dst, (size_t)dst_cap, &actual);
  libdeflate_free_decompressor(d);
  if (rc != LIBDEFLATE_SUCCESS) return -1;
  return (long)actual;
}

#else  // zlib fallback

long tt_deflate(const uint8_t* src, long src_len, int level, uint8_t* dst,
                long dst_cap) {
  if (level > 9) level = 9;
  uLongf out_len = (uLongf)dst_cap;
  int rc = compress2(dst, &out_len, src, (uLong)src_len, level);
  if (rc != Z_OK) return -1;
  return (long)out_len;
}

long tt_inflate(const uint8_t* src, long src_len, uint8_t* dst,
                long dst_cap) {
  uLongf out_len = (uLongf)dst_cap;
  int rc = uncompress(dst, &out_len, src, (uLong)src_len);
  if (rc != Z_OK) return -1;
  return (long)out_len;
}

#endif

// Compress n_tiles tiles (each rows x cols x samples x itemsize bytes,
// contiguous) with the predictor applied, in parallel.
// out_buf must be n_tiles * bound bytes where bound =
// compressBound(tile_bytes); out_sizes[i] receives each tile's size.
// Returns 0 on success.
int tt_deflate_tiles(const uint8_t* data, long n_tiles, int rows,
                     int cols, int samples, int itemsize, int predictor,
                     int level, int n_threads, uint8_t* out_buf,
                     long bound, long* out_sizes) {
  const long tile_bytes = (long)rows * cols * samples * itemsize;
  std::atomic<long> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    std::vector<uint8_t> scratch(tile_bytes);
#ifdef TT_USE_LIBDEFLATE
    int lvl = level < 1 ? 1 : (level > 12 ? 12 : level);
    struct libdeflate_compressor* comp = libdeflate_alloc_compressor(lvl);
    if (!comp) { failed.store(1); return; }
#endif
    while (true) {
      long i = next.fetch_add(1);
      if (i >= n_tiles || failed.load()) break;
      const uint8_t* tile = data + i * tile_bytes;
      const uint8_t* payload = tile;
      if (predictor == 2) {
        std::memcpy(scratch.data(), tile, tile_bytes);
        tt_predict_h(scratch.data(), rows, cols, samples, itemsize);
        payload = scratch.data();
      } else if (predictor == 3) {
        tt_predict_float(tile, scratch.data(), rows, cols, samples,
                         itemsize);
        payload = scratch.data();
      }
#ifdef TT_USE_LIBDEFLATE
      size_t n = libdeflate_zlib_compress(comp, payload,
                                          (size_t)tile_bytes,
                                          out_buf + i * bound,
                                          (size_t)bound);
      long sz = n == 0 ? -1 : (long)n;
#else
      long sz = tt_deflate(payload, tile_bytes, level, out_buf + i * bound,
                           bound);
#endif
      if (sz < 0) { failed.store(1); break; }
      out_sizes[i] = sz;
    }
#ifdef TT_USE_LIBDEFLATE
    libdeflate_free_compressor(comp);
#endif
  };

  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load() ? -1 : 0;
}

// ---------------------------------------------------------------------
// batched block decode: inflate/LZW + predictor inversion + scatter
// ---------------------------------------------------------------------

long tt_lzw_decode(const uint8_t* src, long src_len, uint8_t* dst,
                   long dst_cap);  // defined below

// Decode n_blocks compressed TIFF blocks directly into a destination
// raster, in parallel. This replaces the per-block Python loop of the
// reader (one decode_block call + one NumPy blit per block): one ctypes
// call decodes every block of a band read, inverts the predictor, and
// scatters the intersecting window into the output array — the whole
// ingest-decode stage runs native and GIL-free, so reader pools scale
// with host cores (reference ingest: GDAL ReadAsArray,
// dswx_hls.py:2189-2192).
//
//   src           concatenated raw block bytes
//   offs/sizes    per-block byte ranges into src (size 0 = sparse block:
//                 the GDAL SPARSE_OK convention -> zero fill)
//   blk_rows      decoded rows of each block (strips: last strip short)
//   block_cols    decoded cols of every block (tile width / image width)
//   blk_row0/col0 placement of each block in the full raster
//   compression   1=none, 5=LZW, 8/32946=DEFLATE (zlib format)
//   predictor     1=none, 2=horizontal, 3=float (output native LE)
//   dst           output raster (dst_rows x dst_cols x samples,
//                 itemsize bytes/sample, native LE, C-contiguous),
//                 representing the window [win_r0, win_r0+dst_rows) x
//                 [win_c0, win_c0+dst_cols) of the full image
// Returns 0 on success, -1 on any corrupt block.
int tt_decode_blocks(const uint8_t* src, const int64_t* offs,
                     const int64_t* sizes, int64_t n_blocks,
                     const int32_t* blk_rows, int32_t block_cols,
                     const int64_t* blk_row0, const int64_t* blk_col0,
                     int samples, int itemsize, int compression,
                     int predictor, int n_threads,
                     uint8_t* dst, int64_t dst_rows, int64_t dst_cols,
                     int64_t win_r0, int64_t win_c0) {
  const long px_bytes = (long)samples * itemsize;
  const long dst_row_bytes = (long)dst_cols * px_bytes;
  long max_block_bytes = 0;
  for (int64_t i = 0; i < n_blocks; ++i) {
    const long b = (long)blk_rows[i] * block_cols * px_bytes;
    if (b > max_block_bytes) max_block_bytes = b;
  }
  std::atomic<int64_t> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    std::vector<uint8_t> buf(max_block_bytes);
    std::vector<uint8_t> buf2(predictor == 3 ? max_block_bytes : 0);
#ifdef TT_USE_LIBDEFLATE
    struct libdeflate_decompressor* dec = nullptr;
    if (compression == 8 || compression == 32946) {
      dec = libdeflate_alloc_decompressor();
      if (!dec) { failed.store(1); return; }
    }
#endif
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n_blocks || failed.load()) break;
      const int rows = blk_rows[i];
      const long expected = (long)rows * block_cols * px_bytes;
      uint8_t* block = buf.data();
      if (sizes[i] == 0) {
        std::memset(block, 0, expected);  // sparse block
      } else {
        long got = -1;
        const uint8_t* p = src + offs[i];
        if (compression == 1) {
          got = sizes[i] < expected ? sizes[i] : expected;
          std::memcpy(block, p, got);
        } else if (compression == 8 || compression == 32946) {
#ifdef TT_USE_LIBDEFLATE
          size_t actual = 0;
          enum libdeflate_result rc = libdeflate_zlib_decompress(
              dec, p, (size_t)sizes[i], block, (size_t)expected,
              &actual);
          got = rc == LIBDEFLATE_SUCCESS ? (long)actual : -1;
#else
          got = tt_inflate(p, sizes[i], block, expected);
#endif
        } else if (compression == 5) {
          got = tt_lzw_decode(p, sizes[i], block, expected);
        }
        if (got < 0) { failed.store(1); break; }
        if (got < expected) std::memset(block + got, 0, expected - got);
      }
      if (predictor == 2) {
        tt_unpredict_h(block, rows, block_cols, samples, itemsize);
      } else if (predictor == 3) {
        tt_unpredict_float(block, buf2.data(), rows, block_cols,
                           samples, itemsize);
        block = buf2.data();
      }
      // scatter the intersection of this block with the window
      const int64_t br0 = blk_row0[i], bc0 = blk_col0[i];
      int64_t r_lo = br0 > win_r0 ? br0 : win_r0;
      int64_t r_hi = br0 + rows < win_r0 + dst_rows
                         ? br0 + rows : win_r0 + dst_rows;
      int64_t c_lo = bc0 > win_c0 ? bc0 : win_c0;
      int64_t c_hi = bc0 + block_cols < win_c0 + dst_cols
                         ? bc0 + block_cols : win_c0 + dst_cols;
      if (r_hi <= r_lo || c_hi <= c_lo) continue;
      const long blk_row_bytes = (long)block_cols * px_bytes;
      const long copy_bytes = (long)(c_hi - c_lo) * px_bytes;
      for (int64_t r = r_lo; r < r_hi; ++r) {
        const uint8_t* s = block + (r - br0) * blk_row_bytes
                           + (c_lo - bc0) * px_bytes;
        uint8_t* d = dst + (r - win_r0) * dst_row_bytes
                     + (c_lo - win_c0) * px_bytes;
        std::memcpy(d, s, copy_bytes);
      }
    }
#ifdef TT_USE_LIBDEFLATE
    if (dec) libdeflate_free_decompressor(dec);
#endif
  };

  if (n_threads <= 1 || n_blocks <= 1) {
    worker();
  } else {
    int nt = n_threads;
    if ((int64_t)nt > n_blocks) nt = (int)n_blocks;
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load() ? -1 : 0;
}

// ---------------------------------------------------------------------
// byte LUT map (class-collapse / browse remaps of full product layers)
// ---------------------------------------------------------------------

void tt_lut8(const uint8_t* in, uint8_t* out, int64_t n,
             const uint8_t* lut, int n_threads) {
  const int64_t chunk = 4 << 20;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t c = next.fetch_add(1);
      if (c >= n_chunks) break;
      const int64_t lo = c * chunk;
      const int64_t hi = lo + chunk < n ? lo + chunk : n;
      for (int64_t i = lo; i < hi; ++i) out[i] = lut[in[i]];
    }
  };
  if (n_threads <= 1 || n_chunks <= 1) {
    worker();
  } else {
    int nt = n_threads < (int)n_chunks ? n_threads : (int)n_chunks;
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

// ---------------------------------------------------------------------
// Cubic-B-spline overview decimation (GDAL CUBICSPLINE semantics)
// ---------------------------------------------------------------------

// Separable decimation of a float32 (h, w, s) raster by ``factor``,
// bit-identical to the NumPy reference implementation in io/cog.py
// (_bspline_decimate_axis0 twice): per output element, taps accumulate
// in ascending-tap order in float64, edge windows renormalize by the
// participating weight sum, and the final cast rounds to float32.
// taps/weights are computed once in Python and passed in so both paths
// share the exact same float64 values.
int tt_bspline_decimate_f32(const float* in, long h, long w, long s,
                            int factor, const long* taps,
                            const double* weights, int ntaps,
                            float* out, int n_threads) {
  const long oh = (h + factor - 1) / factor;
  const long ow = (w + factor - 1) / factor;
  const long row_elems = w * s;
  std::vector<double> mid((size_t)oh * row_elems);

  // pass 1: axis 0
  {
    std::atomic<long> next(0);
    auto worker = [&]() {
      while (true) {
        long j = next.fetch_add(1);
        if (j >= oh) break;
        double* num = mid.data() + (size_t)j * row_elems;
        std::memset(num, 0, sizeof(double) * row_elems);
        double den = 0.0;
        for (int t = 0; t < ntaps; ++t) {
          long r = j * (long)factor + taps[t];
          if (r < 0 || r >= h) continue;
          const float* src = in + (size_t)r * row_elems;
          const double wt = weights[t];
          for (long k = 0; k < row_elems; ++k)
            num[k] += wt * (double)src[k];
          den += weights[t];
        }
        for (long k = 0; k < row_elems; ++k) num[k] /= den;
      }
    };
    if (n_threads <= 1) worker();
    else {
      std::vector<std::thread> pool;
      for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
      for (auto& th : pool) th.join();
    }
  }

  // pass 2: axis 1 (per output row, accumulate over column taps in tap
  // order — element order identical to the transposed-axis0 NumPy pass)
  {
    std::atomic<long> next(0);
    auto worker = [&]() {
      std::vector<double> acc(ow * s);
      std::vector<double> den(ow);
      while (true) {
        long i = next.fetch_add(1);
        if (i >= oh) break;
        const double* row = mid.data() + (size_t)i * row_elems;
        std::fill(acc.begin(), acc.end(), 0.0);
        std::fill(den.begin(), den.end(), 0.0);
        for (int t = 0; t < ntaps; ++t) {
          const double wt = weights[t];
          for (long j = 0; j < ow; ++j) {
            long c = j * (long)factor + taps[t];
            if (c < 0 || c >= w) continue;
            const double* v = row + (size_t)c * s;
            double* a = acc.data() + (size_t)j * s;
            for (long k = 0; k < s; ++k) a[k] += wt * v[k];
            den[j] += wt;
          }
        }
        float* orow = out + (size_t)i * ow * s;
        for (long j = 0; j < ow; ++j)
          for (long k = 0; k < s; ++k)
            orow[j * s + k] = (float)(acc[j * s + k] / den[j]);
      }
    };
    if (n_threads <= 1) worker();
    else {
      std::vector<std::thread> pool;
      for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
      for (auto& th : pool) th.join();
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// LZW (TIFF variant: MSB-first codes, early change)
// ---------------------------------------------------------------------

long tt_lzw_decode(const uint8_t* src, long src_len, uint8_t* dst,
                   long dst_cap) {
  // string table: prefix link + suffix byte, decoded iteratively
  const int CLEAR = 256, EOI = 257, TABLE_MAX = 4096;
  std::vector<int> prefix(TABLE_MAX, -1);
  std::vector<uint8_t> suffix(TABLE_MAX, 0);
  std::vector<uint8_t> stack(TABLE_MAX);

  long bitpos = 0;
  const long nbits = src_len * 8;
  int width = 9;
  int table_size = 258;
  int prev_code = -1;
  long out = 0;

  auto read_code = [&]() -> int {
    if (bitpos + width > nbits) return EOI;
    long byte0 = bitpos >> 3;
    uint32_t val = ((uint32_t)src[byte0] << 16);
    if (byte0 + 1 < src_len) val |= ((uint32_t)src[byte0 + 1] << 8);
    if (byte0 + 2 < src_len) val |= (uint32_t)src[byte0 + 2];
    val >>= (24 - (bitpos & 7) - width);
    bitpos += width;
    return (int)(val & ((1u << width) - 1));
  };

  auto emit = [&](int code) -> int {
    // walk the prefix chain onto the stack, then pop
    int sp = 0;
    int c = code;
    while (c >= 256) {
      if (sp >= TABLE_MAX || c >= table_size) return -1;
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    uint8_t first = (uint8_t)c;
    if (out + sp + 1 > dst_cap) return -1;
    dst[out++] = first;
    while (sp > 0) dst[out++] = stack[--sp];
    return first;
  };

  while (true) {
    int code = read_code();
    if (code == EOI) break;
    if (code == CLEAR) {
      width = 9;
      table_size = 258;
      prev_code = -1;
      continue;
    }
    if (prev_code < 0) {
      if (code >= 256) return -1;
      if (out + 1 > dst_cap) return -1;
      dst[out++] = (uint8_t)code;
      prev_code = code;
    } else {
      int first;
      if (code < table_size) {
        first = emit(code);
        if (first < 0) return -1;
        if (table_size < TABLE_MAX) {
          prefix[table_size] = prev_code;
          suffix[table_size] = (uint8_t)first;
          ++table_size;
        }
      } else if (code == table_size) {
        // KwKwK case: new entry is prev + first(prev)
        int c = prev_code;
        while (c >= 256) c = prefix[c];
        if (table_size < TABLE_MAX) {
          prefix[table_size] = prev_code;
          suffix[table_size] = (uint8_t)c;
          ++table_size;
        }
        first = emit(code);
        if (first < 0) return -1;
      } else {
        return -1;  // corrupt stream
      }
      prev_code = code;
    }
    if (table_size + 1 >= (1 << width) && width < 12) ++width;
  }
  return out;
}

}  // extern "C"
