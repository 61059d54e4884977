// kmerdb_jax native host runtime.
//
// The device owns the contraction math (ops/gram.py); this module owns
// the host-side hot loops around it, playing the role the reference's
// C++ runtime plays around its SIMD kernels:
//   * rolling k-mer extraction + minhash window   (cf. src/kmer_extract.h,
//     src/filter.h — re-implemented from the documented semantics)
//   * LSD radix sort of (u64 key, u64 payload)    (replaces pdqsort_par)
//   * segment set-hash statistics for pattern dedup (replaces the
//     pattern-forest insert path of src/prefix_kmer_db.cpp)
//
// Exposed as a plain C ABI consumed via ctypes (utils/native.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <malloc.h>
#include <sys/mman.h>
#endif

// ---------------------------------------------------------------------------
// Host thread pool (the reference runs every hot loop on a spin pool,
// libs/refresh/active_thread_pool/lib/active_thread_pool.h:368; here
// the hot kernels fork/join std::threads per call — spawn cost is
// ~10-50us against multi-second kernels, and idle CPUs cost nothing
// between calls).  Thread count: kmerdb_set_threads() (wired to the
// CLI's -t and KMERDB_THREADS) else hardware_concurrency.
// ---------------------------------------------------------------------------

static std::atomic<int32_t> g_threads{0};  // 0 = auto

extern "C" void kmerdb_set_threads(int32_t n) { g_threads.store(n); }

extern "C" int32_t kmerdb_get_threads(void) {
    int32_t n = g_threads.load();
    if (n > 0) return n;
    unsigned hc = std::thread::hardware_concurrency();
    return hc ? (int32_t)hc : 1;
}

// run fn(t) for t in [0, nt); the calling thread runs t = 0
template <class F>
static void run_parallel(int nt, const F& fn) {
    if (nt <= 1) { fn(0); return; }
    std::vector<std::thread> ths;
    ths.reserve(nt - 1);
    for (int t = 1; t < nt; ++t) ths.emplace_back(fn, t);
    fn(0);
    for (auto& th : ths) th.join();
}

extern "C" {

// ---------------------------------------------------------------------------
// Memory strategy
// ---------------------------------------------------------------------------
//
// Some sandboxed hosts provision anonymous pages at ~30us/page however
// they are touched, which makes every fresh large allocation (numpy
// temporaries included) run at ~0.03 GB/s.  Two mitigations:
//   1. malloc is pinned to the sbrk heap with trimming disabled
//      (below), so freed numpy temporaries keep their provisioned
//      pages inside the process;
//   2. all large native scratch lives in grow-only anonymous-mmap
//      arenas (arena_grow), bulk-provisioned with MADV_POPULATE_WRITE
//      and reused for the life of the process.

// Keep freed memory in the process: malloc'd allocations go to the
// sbrk heap and are never returned to the OS, so their (slow) page
// provisioning cost is paid once per high-water mark.
void kmerdb_malloc_reuse(void) {
#if defined(__linux__)
    mallopt(M_MMAP_MAX, 0);
    mallopt(M_TRIM_THRESHOLD, 0x7fffffff);
#endif
}

// Grow-only anonymous-mmap arena.  On the sandboxed bench hosts,
// MADV_POPULATE_WRITE is ~10x faster per page on fresh MAP_ANONYMOUS
// regions than on brk-heap memory (and ~30x faster than demand
// faults), so all large scratch lives in mmap arenas provisioned in
// bulk and reused forever.
#ifndef MADV_POPULATE_WRITE_
#define MADV_POPULATE_WRITE_ 23
#endif
#ifndef MADV_HUGEPAGE
#define MADV_HUGEPAGE 14
#endif

static void* arena_grow(void** buf, size_t* cap, size_t need) {
#if defined(__linux__)
    if (*cap >= need) return *buf;
    if (*buf) munmap(*buf, *cap);
    size_t ncap = *cap ? *cap : (size_t)1 << 21;
    while (ncap < need) ncap += ncap / 2 + ((size_t)1 << 21);
    ncap = (ncap + ((size_t)1 << 21) - 1) & ~(((size_t)1 << 21) - 1);
    void* p = mmap(nullptr, ncap, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) {
        *buf = nullptr;
        *cap = 0;
        return nullptr;
    }
    madvise(p, ncap, MADV_HUGEPAGE);  // 2 MB pages: ~5x cheaper to
    madvise(p, ncap, MADV_POPULATE_WRITE_);  // provision (measured)
    *buf = p;
    *cap = ncap;
    return p;
#else
    if (*cap >= need) return *buf;
    free(*buf);
    *buf = malloc(need);
    *cap = *buf ? need : 0;
    return *buf;
#endif
}


// ---------------------------------------------------------------------------
// 64-bit mixers
// ---------------------------------------------------------------------------

static inline uint64_t fmix64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

// MinHash hash; matches the construction documented in
// kmerdb_jax/ops/minhash.py (bit-parity with reference filter.h:96-115).
static inline uint64_t minhash_hash(uint64_t kmer, uint64_t k_div_4) {
    uint64_t h = kmer * 0x87c37b91114253d5ULL;
    h = (h << 31) | (h >> 33);
    h *= 0x4cf5ad432745937fULL;
    uint64_t h1 = (42ULL ^ h) ^ k_div_4;
    uint64_t h2 = 42ULL ^ k_div_4;
    h1 += h2;
    h2 += h1;
    h1 = fmix64(h1);
    h2 = fmix64(h2);
    h1 += h2;
    h2 += h1;
    return h1 ^ h2;
}

static inline uint64_t splitmix(uint64_t x, uint64_t salt) {
    uint64_t z = x + salt;
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

// ---------------------------------------------------------------------------
// k-mer extraction (one contig)
// ---------------------------------------------------------------------------
//
// Semantics (same contract as ops/extract.py): rolling forward/reverse
// packing, canonical = min unless preserve_strand, windows containing
// invalid symbols dropped, >=8-bit-prefix widening, optional minhash
// acceptance window.  Returns number of k-mers written to `out`.

int64_t kmerdb_extract(const uint8_t* seq, int64_t len, int32_t k,
                       const int8_t* mapping, int32_t bits, int32_t asize,
                       int32_t preserve, int32_t pshift, uint64_t tailmask,
                       uint64_t lo_thr, uint64_t hi_thr, int32_t use_filter,
                       uint64_t* out) {
    if (len < k) return 0;
    const uint64_t mask =
        (bits * k >= 64) ? ~0ULL : ((1ULL << (bits * k)) - 1);
    const int rev_top = (k - 1) * bits;
    const uint64_t k_div_4 = (uint64_t)((k + 3) / 4);

    uint64_t fwd = 0, rev = 0;
    int omit = 0;
    int64_t n = 0;
    for (int64_t i = 0; i < len; ++i) {
        int8_t s = mapping[seq[i]];
        if (s < 0) {
            s = 0;
            omit = (i >= k - 1) ? k : (int)(i + 1);
        }
        fwd = ((fwd << bits) | (uint64_t)s) & mask;
        rev = (rev >> bits) | ((uint64_t)(asize - 1 - s) << rev_top);
        if (i < k - 1) continue;
        if (omit > 0) { --omit; continue; }
        uint64_t canon = preserve ? fwd : (fwd < rev ? fwd : rev);
        canon = (canon << pshift) | (canon & tailmask);
        if (use_filter) {
            uint64_t h = minhash_hash(canon, k_div_4);
            if (h < lo_thr || h >= hi_thr) continue;
        }
        out[n++] = canon;
    }
    return n;
}

// ---------------------------------------------------------------------------
// LSD radix sort of (uint64 key, uint64 payload), 8-bit digits
// ---------------------------------------------------------------------------

// All 8 digit histograms in ONE read of the array (16 KB of counters,
// L1-resident), then only non-trivial passes scatter.  k-mer keys use
// k*bits <= 62 bits, so the top bytes are constant and their passes
// cost nothing — for k=18 DNA (36-bit keys) this does 1 read + 5
// scatters instead of 8 reads + 5 scatters.
static int radix_histograms(int64_t n, const uint64_t* src,
                            int64_t (*counts)[256]) {
    memset(counts, 0, 8 * 256 * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i) {
        uint64_t x = src[i];
        for (int pass = 0; pass < 8; ++pass)
            ++counts[pass][(x >> (pass * 8)) & 0xff];
    }
    int live = 0;  // bitmask of passes that actually permute
    for (int pass = 0; pass < 8; ++pass) {
        if (counts[pass][(src[0] >> (pass * 8)) & 0xff] == n) continue;
        live |= 1 << pass;
        int64_t sum = 0;
        for (int d = 0; d < 256; ++d) {
            int64_t c = counts[pass][d];
            counts[pass][d] = sum;
            sum += c;
        }
    }
    return live;
}

// One stable parallel scatter pass: per-thread chunk histograms, then
// exclusive digit+chunk prefix bases (chunks in index order keep the
// scatter stable), then each thread scatters its own chunk.
static void radix_pass_parallel(int64_t n, const uint64_t* src,
                                uint64_t* dst, int sh, int nt) {
    std::vector<int64_t> hist((size_t)nt * 256, 0);
    auto chunk = [&](int t, int64_t* lo, int64_t* hi) {
        *lo = n * t / nt;
        *hi = n * (t + 1) / nt;
    };
    run_parallel(nt, [&](int t) {
        int64_t lo, hi;
        chunk(t, &lo, &hi);
        int64_t* h = hist.data() + (size_t)t * 256;
        for (int64_t i = lo; i < hi; ++i) ++h[(src[i] >> sh) & 0xff];
    });
    int64_t sum = 0;
    for (int d = 0; d < 256; ++d) {
        for (int t = 0; t < nt; ++t) {
            int64_t c = hist[(size_t)t * 256 + d];
            hist[(size_t)t * 256 + d] = sum;
            sum += c;
        }
    }
    run_parallel(nt, [&](int t) {
        int64_t lo, hi;
        chunk(t, &lo, &hi);
        int64_t* base = hist.data() + (size_t)t * 256;
        for (int64_t i = lo; i < hi; ++i)
            dst[base[(src[i] >> sh) & 0xff]++] = src[i];
    });
}

void kmerdb_radix_sort_k(int64_t n, uint64_t* keys, uint64_t* tkeys) {
    if (n <= 1) return;
    uint64_t* src = keys;
    uint64_t* dst = tkeys;
    int nt = kmerdb_get_threads();
    // parallel pay-off needs ~1M+ elements (2 reads/pass vs the serial
    // path's single fused histogram read)
    if (nt > 1 && n >= (1 << 20)) {
        if (nt > 16) nt = 16;
        // live-pass detection: one parallel histogram read of all 8
        // digit positions
        std::vector<int64_t> counts8((size_t)nt * 8 * 256, 0);
        run_parallel(nt, [&](int t) {
            const int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
            int64_t* h = counts8.data() + (size_t)t * 8 * 256;
            for (int64_t i = lo; i < hi; ++i) {
                uint64_t x = src[i];
                for (int pass = 0; pass < 8; ++pass)
                    ++h[pass * 256 + ((x >> (pass * 8)) & 0xff)];
            }
        });
        for (int pass = 0; pass < 8; ++pass) {
            int64_t top = 0;
            const int d0 = (int)((src == keys ? keys[0] : src[0])
                                 >> (pass * 8)) & 0xff;
            for (int t = 0; t < nt; ++t)
                top += counts8[(size_t)t * 8 * 256 + pass * 256 + d0];
            if (top == n) continue;  // constant digit: skip the pass
            radix_pass_parallel(n, src, dst, pass * 8, nt);
            uint64_t* tmp = src; src = dst; dst = tmp;
        }
        if (src != keys) memcpy(keys, src, (size_t)n * 8);
        return;
    }
    // 12-bit digits beat 8-bit at every key width (k=18 DNA: 36-bit
    // keys, 3 scatter passes instead of 5; full 64-bit, 6 instead of
    // 8) — the extra OR-reduction read (~1 ns/elem) is far cheaper
    // than the scatters it removes (~3.5 ns/elem each, measured).
    // Tiny arrays keep the 8-bit path (prefix-sum overhead dominates).
    uint64_t acc = 0;
    for (int64_t i = 0; i < n; ++i) acc |= keys[i];
    if (acc == 0) return;  // all-zero keys: already sorted
    // bounded width scan: `acc >> bits` with bits reaching 64 is UB
    // (masked to a no-op shift on x86/ARM — an infinite loop when
    // bit 63 is set, e.g. k=32 DNA codes)
    int bits = 64;
    while (bits > 1 && !(acc >> (bits - 1))) --bits;
    if (n >= 32768) {  // below this the wider prefix sums wash the win
        const int passes = (bits + 11) / 12;
        static thread_local int64_t hist_tl[6 * 4096];
        int64_t* hist = hist_tl;
        memset(hist, 0, (size_t)passes * 4096 * 8);
        for (int64_t i = 0; i < n; ++i) {
            const uint64_t x = keys[i];
            for (int p = 0; p < passes; ++p)
                ++hist[(size_t)p * 4096 + ((x >> (p * 12)) & 0xfff)];
        }
        for (int p = 0; p < passes; ++p) {
            int64_t* h = hist + (size_t)p * 4096;
            if (h[(src[0] >> (p * 12)) & 0xfff] == n) continue;
            int64_t sum = 0;
            for (int d = 0; d < 4096; ++d)
                { int64_t v = h[d]; h[d] = sum; sum += v; }
            const int sh = p * 12;
            for (int64_t i = 0; i < n; ++i)
                dst[h[(src[i] >> sh) & 0xfff]++] = src[i];
            uint64_t* tmp = src; src = dst; dst = tmp;
        }
        if (src != keys) memcpy(keys, src, (size_t)n * 8);
        return;
    }
    int64_t counts[8][256];  // 16 KB, fine on the stack
    const int live = radix_histograms(n, keys, counts);
    for (int pass = 0; pass < 8; ++pass) {
        if (!(live & (1 << pass))) continue;
        const int sh = pass * 8;
        int64_t* cnt = counts[pass];
        for (int64_t i = 0; i < n; ++i)
            dst[cnt[(src[i] >> sh) & 0xff]++] = src[i];
        uint64_t* t = src; src = dst; dst = t;
    }
    if (src != keys) memcpy(keys, src, (size_t)n * 8);
}

// sorted array -> unique in place; returns new count
int64_t kmerdb_unique_u64(int64_t n, uint64_t* a) {
    if (n == 0) return 0;
    int64_t m = 1;
    for (int64_t i = 1; i < n; ++i)
        if (a[i] != a[m - 1]) a[m++] = a[i];
    return m;
}


// ---------------------------------------------------------------------------
// Fused K-way merge + group statistics
// ---------------------------------------------------------------------------
//
// Each input stream is sorted by key.  Stream i supplies keys[i][j] and
// value vals[i][j] (or the constant const_val[i] when vals[i] == null —
// sample streams carry their sample id for every element).  Values are
// uint32: plain sample ids < 2^31, or (1<<31)|pattern_id references to
// the existing database.  Streams are merged with stable tie-breaking
// by stream index (the old-database stream must come first), emitting
// the merged value stream plus one record per distinct key: start,
// length, xor/sum content hashes.  Returns #groups.  merged_vals must
// have room for the total element count; group arrays likewise.
//
// Keys and values live in split arrays (12 B/element instead of a
// padded 16 B struct): on slow-page-provisioning hosts the cold build
// cost is proportional to unique bytes touched.

// stable two-way merge of (key, value) runs (ties: a before b);
// branchless inner loop (cmov-friendly) — random keys make the
// take-a/take-b branch unpredictable, which dominates on narrow cores.
static void merge_runs(const uint64_t* ak, const uint32_t* av, int64_t na,
                       const uint64_t* bk, const uint32_t* bv, int64_t nb,
                       uint64_t* ok, uint32_t* ov) {
    int64_t i = 0, j = 0, o = 0;
    while (i < na && j < nb) {
        const uint64_t ka = ak[i], kb = bk[j];
        const uint32_t va = av[i], vb = bv[j];
        const bool take_b = kb < ka;
        ok[o] = take_b ? kb : ka;
        ov[o] = take_b ? vb : va;
        ++o;
        i += !take_b;
        j += take_b;
    }
    if (i < na) {
        memcpy(ok + o, ak + i, (size_t)(na - i) * 8);
        memcpy(ov + o, av + i, (size_t)(na - i) * 4);
    } else if (j < nb) {
        memcpy(ok + o, bk + j, (size_t)(nb - j) * 8);
        memcpy(ov + o, bv + j, (size_t)(nb - j) * 4);
    }
}

// Key-range bucketing: the streams are partitioned at sampled key
// quantiles so every bucket's records fit in L2; the pairwise merge
// tree then runs entirely in cache.  Out-of-cache traffic is one
// materialization pass + one stats pass instead of log2(n_streams)
// full-size merge passes (the dominant cost on a narrow host).
int64_t kmerdb_merge_groups(int32_t n_streams, const uint64_t** keys,
                            const uint32_t** vals, const uint32_t* const_val,
                            const int64_t* lens, uint32_t* merged_vals,
                            uint64_t* group_keys, int64_t* gstart,
                            uint64_t* glen, uint64_t* h1, uint64_t* h2) {
    int64_t total = 0;
    for (int32_t s = 0; s < n_streams; ++s) total += lens[s];
    if (total == 0) return 0;

    // ---- bucket edges from sampled keys (quantiles of the merged
    // distribution; k-mer keys are sequence-biased, so fixed top-bit
    // splits would be unbalanced)
    const int64_t kTargetBucket = 1 << 16;  // 64k records = 1 MiB of KV
    int64_t n_buckets = total / kTargetBucket;
    if (n_buckets > 4096) n_buckets = 4096;
    if (n_buckets < 1) n_buckets = 1;
    std::vector<uint64_t> edges;
    if (n_buckets > 1) {
        std::vector<uint64_t> sample;
        const int64_t stride = total / 32768 ? total / 32768 : 1;
        for (int32_t s = 0; s < n_streams; ++s)
            for (int64_t i = 0; i < lens[s]; i += stride)
                sample.push_back(keys[s][i]);
        // sample stays small (<=~33k): std::sort is fine
        std::sort(sample.begin(), sample.end());
        for (int64_t b = 1; b < n_buckets; ++b) {
            uint64_t e = sample[(size_t)(b * (int64_t)sample.size()
                                         / n_buckets)];
            if (edges.empty() || e > edges.back()) edges.push_back(e);
        }
        n_buckets = (int64_t)edges.size() + 1;
    }
    const int64_t nb = n_buckets;

    // ---- per (stream, bucket) split points: cuts[s*(nb+1) + b]
    std::vector<int64_t> cuts((size_t)n_streams * (nb + 1));
    for (int32_t s = 0; s < n_streams; ++s) {
        int64_t* c = cuts.data() + (size_t)s * (nb + 1);
        c[0] = 0;
        c[nb] = lens[s];
        for (int64_t b = 0; b + 1 < nb; ++b) {
            const uint64_t* lo =
                std::lower_bound(keys[s] + c[b], keys[s] + lens[s], edges[b]);
            c[b + 1] = lo - keys[s];
        }
    }

    // ---- bucket bases + max bucket size
    std::vector<int64_t> bucket_base(nb + 1, 0);
    int64_t max_bucket = 0;
    for (int64_t b = 0; b < nb; ++b) {
        int64_t sz = 0;
        for (int32_t s = 0; s < n_streams; ++s) {
            const int64_t* c = cuts.data() + (size_t)s * (nb + 1);
            sz += c[b + 1] - c[b];
        }
        bucket_base[b + 1] = bucket_base[b] + sz;
        if (sz > max_bucket) max_bucket = sz;
    }

    // persistent scratch (grow-only mmap arenas): fresh pages are
    // expensive on some sandboxed hosts, reused ones are full-bandwidth.
    // Layout: keys (8 B, aligned) first, then values (4 B).
    static void* arena_buf = nullptr;
    static size_t arena_cap = 0;
    static void* scratch_buf = nullptr;
    static size_t scratch_cap = 0;
    uint64_t* arena_k = (uint64_t*)arena_grow(&arena_buf, &arena_cap,
                                              (size_t)total * 12);
    uint64_t* scratch_k = (uint64_t*)arena_grow(&scratch_buf, &scratch_cap,
                                                (size_t)max_bucket * 12);
    if (!arena_k || !scratch_k) return -1;
    uint32_t* arena_v = (uint32_t*)(arena_k + total);
    uint32_t* scratch_v = (uint32_t*)(scratch_k + max_bucket);

    // ---- materialize records bucket-major, streams in order (the
    // stable tie-break: stream 0 = old database first)
    {
        std::vector<int64_t> wp(bucket_base.begin(), bucket_base.end() - 1);
        for (int32_t s = 0; s < n_streams; ++s) {
            const int64_t* c = cuts.data() + (size_t)s * (nb + 1);
            const uint64_t* ks = keys[s];
            const uint32_t* vs = vals[s];
            const uint32_t cv = vs ? 0 : const_val[s];
            for (int64_t b = 0; b < nb; ++b) {
                const int64_t w = wp[b];
                const int64_t n = c[b + 1] - c[b];
                memcpy(arena_k + w, ks + c[b], (size_t)n * 8);
                if (vs)
                    memcpy(arena_v + w, vs + c[b], (size_t)n * 4);
                else
                    for (int64_t i = 0; i < n; ++i) arena_v[w + i] = cv;
                wp[b] += n;
            }
        }
    }

    // ---- per bucket: in-cache pairwise merge tree, then stats
    int64_t g = -1;
    std::vector<int64_t> run_off, run_len, noff, nlen;
    for (int64_t b = 0; b < nb; ++b) {
        const int64_t base = bucket_base[b];
        const int64_t bsz = bucket_base[b + 1] - bucket_base[b];
        if (bsz == 0) continue;
        run_off.clear();
        run_len.clear();
        int64_t off = 0;
        for (int32_t s = 0; s < n_streams; ++s) {
            const int64_t* c = cuts.data() + (size_t)s * (nb + 1);
            const int64_t n = c[b + 1] - c[b];
            if (n == 0) continue;
            run_off.push_back(off);
            run_len.push_back(n);
            off += n;
        }
        uint64_t* src_k = arena_k + base;
        uint32_t* src_v = arena_v + base;
        uint64_t* dst_k = scratch_k;
        uint32_t* dst_v = scratch_v;
        while (run_off.size() > 1) {
            noff.clear();
            nlen.clear();
            for (size_t r = 0; r + 1 < run_off.size(); r += 2) {
                merge_runs(src_k + run_off[r], src_v + run_off[r],
                           run_len[r],
                           src_k + run_off[r + 1], src_v + run_off[r + 1],
                           run_len[r + 1],
                           dst_k + run_off[r], dst_v + run_off[r]);
                noff.push_back(run_off[r]);
                nlen.push_back(run_len[r] + run_len[r + 1]);
            }
            if (run_off.size() & 1) {
                size_t r = run_off.size() - 1;
                memcpy(dst_k + run_off[r], src_k + run_off[r],
                       (size_t)run_len[r] * 8);
                memcpy(dst_v + run_off[r], src_v + run_off[r],
                       (size_t)run_len[r] * 4);
                noff.push_back(run_off[r]);
                nlen.push_back(run_len[r]);
            }
            run_off.swap(noff);
            run_len.swap(nlen);
            std::swap(src_k, dst_k);
            std::swap(src_v, dst_v);
        }

        const int64_t out0 = base;
        uint64_t prev_key = ~src_k[0];
        if (h1) {
            for (int64_t i = 0; i < bsz; ++i) {
                const uint64_t k = src_k[i];
                const uint32_t v = src_v[i];
                if (k != prev_key) {
                    ++g;
                    group_keys[g] = k;
                    gstart[g] = out0 + i;
                    glen[g] = 0;
                    h1[g] = 0;
                    h2[g] = 0;
                    prev_key = k;
                }
                merged_vals[out0 + i] = v;
                glen[g] += 1;
                h1[g] ^= splitmix(v, 0x9e3779b97f4a7c15ULL);
                h2[g] += splitmix(v, 0xc2b2ae3d27d4eb4fULL);
            }
        } else {
            // hash-free stats (the fused group-Gram path never reads
            // the set hashes: groups are not deduplicated)
            for (int64_t i = 0; i < bsz; ++i) {
                const uint64_t k = src_k[i];
                if (k != prev_key) {
                    ++g;
                    group_keys[g] = k;
                    gstart[g] = out0 + i;
                    glen[g] = 0;
                    prev_key = k;
                }
                merged_vals[out0 + i] = src_v[i];
                glen[g] += 1;
            }
        }
    }
    return g + 1;
}

// ---------------------------------------------------------------------------
// Pattern dedup by order-invariant content hash
// ---------------------------------------------------------------------------
//
// Groups whose (h1, h2, len) content triples match are the same sample
// set -> one pattern.  Sort by a combined hash (stable LSD radix), cut
// runs on any triple change.  inverse[g] = pattern id of group g;
// first_group[p] = lowest group index of pattern p.  Returns #patterns.

int64_t kmerdb_dedup_groups(int64_t G, const uint64_t* h1,
                            const uint64_t* h2, const uint64_t* glen,
                            int64_t* inverse, int64_t* first_group) {
    if (G == 0) return 0;
    // open-addressing first-touch table: pattern ids are assigned in
    // input order, one random-access probe chain per group — O(G)
    // instead of a full 64-bit KV radix sort of the combined hashes.
    size_t cap = 2;
    while (cap < (size_t)G * 2) cap <<= 1;
    const size_t mask = cap - 1;
    static void* dd_buf = nullptr;
    static size_t dd_cap = 0;
    int64_t* slot = (int64_t*)arena_grow(&dd_buf, &dd_cap,
                                         cap * sizeof(int64_t));
    if (!slot) return -1;
    memset(slot, 0xff, cap * sizeof(int64_t));  // -1 = empty
    int64_t p = 0;
    for (int64_t i = 0; i < G; ++i) {
        uint64_t r = (h2[i] << 17) | (h2[i] >> 47);
        size_t pos = splitmix(h1[i] ^ r ^ glen[i],
                              0x9e3779b97f4a7c15ULL) & mask;
        for (;;) {
            const int64_t f = slot[pos];
            if (f < 0) {
                slot[pos] = i;
                first_group[p] = i;
                inverse[i] = p++;
                break;
            }
            if (h1[f] == h1[i] && h2[f] == h2[i] && glen[f] == glen[i]) {
                inverse[i] = inverse[f];
                break;
            }
            pos = (pos + 1) & mask;
        }
    }
    return p;
}

// ---------------------------------------------------------------------------
// Ragged gather: out[out_off[i]..] = src[src_off[sel[i]]..src_off[sel[i]+1])
// (CSR compaction after cross-partition pattern dedup)
// ---------------------------------------------------------------------------

void kmerdb_gather_ragged_u32(int64_t n_sel, const int64_t* sel,
                              const int64_t* src_off, const uint32_t* src,
                              const int64_t* out_off, uint32_t* out) {
    for (int64_t i = 0; i < n_sel; ++i) {
        const int64_t lo = src_off[sel[i]], hi = src_off[sel[i] + 1];
        memcpy(out + out_off[i], src + lo, (size_t)(hi - lo) * 4);
    }
}

// ---------------------------------------------------------------------------
// one2all membership probe: galloping sorted-vs-sorted lookup
// ---------------------------------------------------------------------------
//
// Both the query array and the database k-mer array are sorted unique;
// consecutive queries land monotonically later in the database, so each
// lookup gallops forward from the previous hit position instead of
// bisecting the whole array (reference one2all probes a hashtable per
// k-mer, similarity_calculator.cpp:679-706).  Emits the pattern id of
// every query present in the database; returns the hit count.

int64_t kmerdb_one2all_probe(int64_t nq, const uint64_t* q, int64_t n,
                             const uint64_t* kmers, const int32_t* pids,
                             int32_t* hit_pids) {
    int64_t pos = 0, h = 0;
    for (int64_t i = 0; i < nq && pos < n; ++i) {
        const uint64_t key = q[i];
        int64_t lo = pos, step = 1;
        while (lo + step < n && kmers[lo + step] < key) {
            lo += step;
            step <<= 1;
        }
        int64_t hi = lo + step;
        if (hi > n) hi = n;
        const uint64_t* p = std::lower_bound(kmers + lo, kmers + hi, key);
        pos = p - kmers;
        if (pos < n && kmers[pos] == key) hit_pids[h++] = pids[pos];
    }
    return h;
}

// Batched multi-query probe (new2all's host stage, reference
// console_new2all.cpp:64-95 runs one query per pool thread).  The
// per-query galloping probe re-reads the whole db k-mer array once
// PER QUERY (Q * 8n bytes of traffic); this batched form partitions
// the db into cache-sized key ranges and, range by range, intersects
// every query's slice against the RESIDENT db slice — the db streams
// from RAM exactly once for the whole batch, and ranges fan out
// across threads.  A second parallel-over-queries pass radix-sorts
// each query's hit pattern ids and run-length-counts them in place.
//
// Outputs land per query at base qoffs[q] (capacity = query length,
// an upper bound on hits): out_pids[qoffs[q] .. +ucnt[q]) = ascending
// unique hit pattern ids, out_cnts likewise their multiplicities.
// Returns the global max multiplicity (limb sizing), or -1 on alloc
// failure.  Queries must be sorted unique (np.unique'd by callers).
int64_t kmerdb_many2all_probe(
    int32_t n_queries, const uint64_t** qs, const int64_t* qlens,
    const int64_t* qoffs, int64_t n, const uint64_t* kmers,
    const int32_t* pids, int64_t n_patterns, int32_t* out_pids,
    uint32_t* out_cnts, int64_t* out_ucnt) {
    const int64_t Q = n_queries;
    if (Q == 0) return 0;
    if (n == 0) {
        for (int64_t q = 0; q < Q; ++q) out_ucnt[q] = 0;
        return 0;
    }
    // db ranges of ~128k keys: 1 MB of keys + 0.5 MB of pids stays
    // resident in L2 while all Q query slices stream past it
    const int64_t RL = 128 << 10;
    int64_t R = (n + RL - 1) / RL;
    if (R > 4096) R = 4096;
    int64_t qmax = 0, total_q = 0;
    for (int64_t q = 0; q < Q; ++q) {
        if (qlens[q] > qmax) qmax = qlens[q];
        total_q += qlens[q];
    }

    int nt = kmerdb_get_threads();
    if (nt > 16) nt = 16;

    // direct pattern-id histograms (one u32[n_patterns] per thread)
    // replace the sort+run-length pass whenever they fit: bounded so a
    // pathological pattern count can't blow the arena
    const bool want_hist =
        n_patterns > 0 && (size_t)nt * n_patterns * 4 <= (128u << 20);

    static void* m2a_buf = nullptr;
    static size_t m2a_cap = 0;
    // layout: cuts i64[Q*(R+1)] | hcnt i64[Q*R] | tmp i32[total_q]
    //         | radix scratch i32[nt*qmax] | hist u32[nt*n_patterns]
    const size_t need = (size_t)Q * (R + 1) * 8 + (size_t)Q * R * 8
        + (size_t)total_q * 4 + (size_t)nt * qmax * 4
        + (want_hist ? (size_t)nt * n_patterns * 4 : 0);
    int64_t* cuts = (int64_t*)arena_grow(&m2a_buf, &m2a_cap, need);
    if (!cuts) return -1;
    int64_t* hcnt = cuts + (size_t)Q * (R + 1);
    int32_t* tmp = (int32_t*)(hcnt + (size_t)Q * R);
    int32_t* rscratch = tmp + total_q;
    uint32_t* hist_base = want_hist
        ? (uint32_t*)(rscratch + (size_t)nt * qmax) : nullptr;

    // KMERDB_PROBE_STATS=1: per-phase wall times on stderr (tuning)
    const bool stats = [] {
        const char* e = getenv("KMERDB_PROBE_STATS");
        return e && *e == '1';
    }();
    auto now = [] { return std::chrono::steady_clock::now(); };
    auto t0 = now();
    auto lap = [&](const char* name) {
        if (!stats) return;
        auto t1 = now();
        fprintf(stderr, "m2a_probe %s %.3f s\n", name,
                std::chrono::duration<double>(t1 - t0).count());
        t0 = t1;
    };

    // per-query range cut positions (monotonic galloping lower_bound
    // per edge; queries are independent -> parallel)
    run_parallel(Q < 64 ? 1 : nt, [&](int t) {
        const int tn = Q < 64 ? 1 : nt;
        for (int64_t q = t; q < Q; q += tn) {
            const uint64_t* qa = qs[q];
            const int64_t ql = qlens[q];
            int64_t* c = cuts + (size_t)q * (R + 1);
            c[0] = 0;
            int64_t pos = 0;
            for (int64_t r = 1; r < R; ++r) {
                const uint64_t edge = kmers[(n * r) / R];
                int64_t step = 1;
                while (pos + step < ql && qa[pos + step] < edge)
                    { pos += step; step <<= 1; }
                int64_t hi = pos + step < ql ? pos + step : ql;
                pos = std::lower_bound(qa + pos, qa + hi, edge) - qa;
                c[r] = pos;
            }
            c[R] = ql;
        }
    });
    lap("cuts");

    // range-major intersect: thread t owns range r, db slice resident.
    // Within a range, each query's keys are searched with an 8-WAY
    // INTERLEAVED branchless lower_bound over the resident slice: the
    // length-halving loop is lockstep across lanes (shared `len`), so
    // eight independent L2 loads are in flight per step instead of a
    // branch-mispredicting gallop chain (~3x per-key, measured on the
    // bench host).  Short query slices keep the scalar gallop.
    std::atomic<int64_t> next_r{0};
    run_parallel(nt, [&](int) {
        for (;;) {
            const int64_t r = next_r.fetch_add(1);
            if (r >= R) break;
            const int64_t d0 = (n * r) / R, d1 = (n * (r + 1)) / R;
            const uint64_t* slice = kmers + d0;
            const int64_t m = d1 - d0;
            for (int64_t q = 0; q < Q; ++q) {
                const int64_t* c = cuts + (size_t)q * (R + 1);
                const uint64_t* qa = qs[q];
                int64_t i = c[r];
                const int64_t iend = c[r + 1];
                int32_t* outp = tmp + qoffs[q] + c[r];
                int64_t h = 0;
                if (m > 0) {
                    // 16 lanes: the lockstep loads are independent L2
                    // accesses, and 16 in flight saturates the load
                    // queue where 8 left latency on the table
                    for (; i + 16 <= iend; i += 16) {
                        int64_t base[16] = {0};
                        int64_t len = m;
                        while (len > 1) {
                            const int64_t half = len >> 1;
                            for (int j = 0; j < 16; ++j)
                                base[j] += (slice[base[j] + half - 1]
                                            < qa[i + j]) ? half : 0;
                            len -= half;
                        }
                        for (int j = 0; j < 16; ++j) {
                            const int64_t p =
                                base[j] + (slice[base[j]] < qa[i + j]);
                            if (p < m && slice[p] == qa[i + j])
                                outp[h++] = pids[d0 + p];
                        }
                    }
                    for (; i + 8 <= iend; i += 8) {
                        int64_t base[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                        int64_t len = m;
                        while (len > 1) {
                            const int64_t half = len >> 1;
                            for (int j = 0; j < 8; ++j)
                                base[j] += (slice[base[j] + half - 1]
                                            < qa[i + j]) ? half : 0;
                            len -= half;
                        }
                        for (int j = 0; j < 8; ++j) {
                            const int64_t p =
                                base[j] + (slice[base[j]] < qa[i + j]);
                            if (p < m && slice[p] == qa[i + j])
                                outp[h++] = pids[d0 + p];
                        }
                    }
                    int64_t pos = d0;
                    for (; i < iend && pos < d1; ++i) {
                        const uint64_t key = qa[i];
                        int64_t lo = pos, step = 1;
                        while (lo + step < d1 && kmers[lo + step] < key)
                            { lo += step; step <<= 1; }
                        int64_t hi = lo + step < d1 ? lo + step : d1;
                        pos = std::lower_bound(kmers + lo, kmers + hi,
                                               key) - kmers;
                        if (pos < d1 && kmers[pos] == key)
                            outp[h++] = pids[pos];
                    }
                }
                hcnt[(size_t)q * R + r] = h;
            }
        }
    });
    lap("intersect");

    // per-query: radix-sort hits by pid straight out of the range
    // segments, then run-length count in place.  Pattern ids fit 22
    // bits for any realistic database, so two 11-bit passes cover it
    // (pass 1 scatters segment hits -> thread scratch, pass 2 scratch
    // -> out region); both digit histograms are counted in ONE read
    // of the segments, and the separate compaction pass disappears
    // into pass 1's scatter.  Wider ids fall back to 8-bit passes.
    int pid_bits = 1;
    while (((int64_t)1 << pid_bits) < n_patterns) ++pid_bits;
    std::atomic<int64_t> next_q{0};
    std::atomic<int64_t> max_cnt{1};
    run_parallel(nt, [&](int t) {
        int32_t* scratch = rscratch + (size_t)t * qmax;
        int64_t local_max = 1;
        // lazy: this thread's histogram is zeroed on first hist-path
        // use only (the emission scan restores zeros afterwards), so a
        // sparse pattern space that keeps every query on the sort path
        // never pays the up-to-128 MB wipe
        bool hist_zeroed = false;
        for (;;) {
            const int64_t q = next_q.fetch_add(1);
            if (q >= Q) break;
            const int64_t* c = cuts + (size_t)q * (R + 1);
            const int32_t* seg_base = tmp + qoffs[q];
            int32_t* dst = out_pids + qoffs[q];
            int64_t h = 0;
            for (int64_t r = 0; r < R; ++r)
                h += hcnt[(size_t)q * R + r];
            if (h == 0) { out_ucnt[q] = 0; continue; }
            if (want_hist && n_patterns <= 2 * h + 4096) {
                // direct count: one pass of random increments into the
                // (cache-warm) per-thread table + one emission scan
                // that re-zeroes as it reads — ~half the sort path's
                // memory traffic, and the ascending-pid output order
                // falls out of the scan.  Gated on density so a huge
                // sparse pattern space keeps the sort path.
                uint32_t* hist = hist_base + (size_t)t * n_patterns;
                if (!hist_zeroed) {
                    memset(hist, 0, (size_t)n_patterns * 4);
                    hist_zeroed = true;
                }
                for (int64_t r = 0; r < R; ++r) {
                    const int32_t* s = seg_base + c[r];
                    const int64_t nseg = hcnt[(size_t)q * R + r];
                    for (int64_t i = 0; i < nseg; ++i) ++hist[s[i]];
                }
                uint32_t* dcnt0 = out_cnts + qoffs[q];
                int64_t u = 0;
                for (int64_t p = 0; p < n_patterns; ++p) {
                    const uint32_t v = hist[p];
                    if (v) {
                        hist[p] = 0;
                        dst[u] = (int32_t)p;
                        dcnt0[u++] = v;
                        if ((int64_t)v > local_max) local_max = v;
                    }
                }
                out_ucnt[q] = u;
                continue;
            }
            if (pid_bits <= 22) {
                // both 11-bit digit histograms in one segment read
                int64_t cnt0[2048], cnt1[2048];
                memset(cnt0, 0, sizeof(cnt0));
                memset(cnt1, 0, sizeof(cnt1));
                for (int64_t r = 0; r < R; ++r) {
                    const int32_t* s = seg_base + c[r];
                    const int64_t nseg = hcnt[(size_t)q * R + r];
                    for (int64_t i = 0; i < nseg; ++i) {
                        ++cnt0[s[i] & 0x7ff];
                        ++cnt1[(s[i] >> 11) & 0x7ff];
                    }
                }
                int64_t sum = 0;
                for (int d = 0; d < 2048; ++d)
                    { int64_t v = cnt0[d]; cnt0[d] = sum; sum += v; }
                sum = 0;
                for (int d = 0; d < 2048; ++d)
                    { int64_t v = cnt1[d]; cnt1[d] = sum; sum += v; }
                // pass 1: segments -> scratch (low digit); doubles as
                // the compaction pass
                for (int64_t r = 0; r < R; ++r) {
                    const int32_t* s = seg_base + c[r];
                    const int64_t nseg = hcnt[(size_t)q * R + r];
                    for (int64_t i = 0; i < nseg; ++i)
                        scratch[cnt0[s[i] & 0x7ff]++] = s[i];
                }
                // pass 2: scratch -> out region (high digit)
                for (int64_t i = 0; i < h; ++i)
                    dst[cnt1[(scratch[i] >> 11) & 0x7ff]++] = scratch[i];
            } else {
                // wide ids: compact then classic 8-bit LSD passes
                int64_t h2 = 0;
                for (int64_t r = 0; r < R; ++r) {
                    const int64_t hc = hcnt[(size_t)q * R + r];
                    if (hc) {
                        memcpy(dst + h2, seg_base + c[r],
                               (size_t)hc * 4);
                        h2 += hc;
                    }
                }
                int32_t* src = dst;
                int32_t* alt = scratch;
                const int passes = (pid_bits + 7) / 8;
                for (int p = 0; p < passes; ++p) {
                    int64_t cnt[256] = {0};
                    const int sh = p * 8;
                    for (int64_t i = 0; i < h; ++i)
                        ++cnt[(src[i] >> sh) & 0xff];
                    if (cnt[(src[0] >> sh) & 0xff] == h) continue;
                    int64_t sum = 0;
                    for (int d = 0; d < 256; ++d)
                        { int64_t v = cnt[d]; cnt[d] = sum; sum += v; }
                    for (int64_t i = 0; i < h; ++i)
                        alt[cnt[(src[i] >> sh) & 0xff]++] = src[i];
                    std::swap(src, alt);
                }
                if (src != dst) memcpy(dst, src, (size_t)h * 4);
            }
            uint32_t* dcnt = out_cnts + qoffs[q];
            int64_t u = 0;
            int32_t prev = dst[0];
            uint32_t run = 0;
            for (int64_t i = 0; i < h; ++i) {
                if (dst[i] != prev) {
                    dst[u] = prev;
                    dcnt[u++] = run;
                    if ((int64_t)run > local_max) local_max = run;
                    prev = dst[i];
                    run = 1;
                } else {
                    ++run;
                }
            }
            dst[u] = prev;
            dcnt[u++] = run;
            if ((int64_t)run > local_max) local_max = run;
            out_ucnt[q] = u;
        }
        int64_t cur = max_cnt.load();
        while (local_max > cur &&
               !max_cnt.compare_exchange_weak(cur, local_max)) {}
    });
    lap("rle");
    return max_cnt.load();
}

// Batched CSR apply: query rows are disjoint, so the per-query
// one2all accumulation fans out across threads (the multi-query form
// of kmerdb_csr_apply; reference decode loop
// similarity_calculator.cpp:737-794 under T query threads).
void kmerdb_csr_apply_many(
    int32_t n_queries, const int64_t* qoffs, const int64_t* ucnt,
    const int32_t* hit_pids, const uint32_t* hit_cnts,
    const int64_t* offsets, const uint32_t* sample_ids,
    int64_t n_samples, uint32_t* out) {
    int nt = kmerdb_get_threads();
    if (nt > 16) nt = 16;
    if (nt > n_queries) nt = n_queries > 0 ? (int)n_queries : 1;
    std::atomic<int64_t> next{0};
    run_parallel(nt, [&](int) {
        for (;;) {
            const int64_t q = next.fetch_add(1);
            if (q >= n_queries) break;
            const int32_t* hp = hit_pids + qoffs[q];
            const uint32_t* hc = hit_cnts + qoffs[q];
            uint32_t* sims = out + (size_t)q * n_samples;
            const int64_t u = ucnt[q];
            for (int64_t i = 0; i < u; ++i) {
                const int64_t p = hp[i];
                const uint32_t cv = hc[i];
                const int64_t lo = offsets[p], hi = offsets[p + 1];
                for (int64_t j = lo; j < hi; ++j)
                    sims[sample_ids[j]] += cv;
            }
        }
    });
}

// Pattern-major batched apply: same contract as kmerdb_csr_apply_many
// but iterating hit PATTERNS instead of queries.  The query-major
// form re-reads each hit pattern's sample list once per query — ~23
// GB of CSR traffic on a related 4k-sample corpus where patterns
// average ~700 samples.  Pattern-major reads each list once, and a
// pattern dense enough to cover much of the sample axis applies as a
// SIMD AXPY (out_row += c * 0/1-row) over a slice materialized once
// and shared by all queries hitting it.  Threads own disjoint
// sample-axis ranges (pattern sample ids are ascending, so each
// thread slices by two binary searches), keeping writes conflict-free
// with no per-thread output copies.
extern "C++" template <typename T>
void pm_apply(int nt, int64_t P, int64_t S, const int64_t* pq_off,
                     const int32_t* pq_q, const uint32_t* pq_c,
                     const int64_t* offsets, const uint32_t* sample_ids,
                     T* acc, T* rows) {
    // lanes per "cycle unit" in the cost model below (AVX2: 8 u32 or
    // 16 u16 per vector op)
    const int64_t V = 32 / (int64_t)sizeof(T);
    run_parallel(nt, [&](int t) {
        const int64_t s_lo = S * t / nt, s_hi = S * (t + 1) / nt;
        const int64_t sw = s_hi - s_lo;
        T* row = rows + (size_t)t * S;
        for (int64_t p = 0; p < P; ++p) {
            const int64_t k = pq_off[p + 1] - pq_off[p];
            if (k == 0) continue;
            const uint32_t* sb = sample_ids + offsets[p];
            const int64_t len = offsets[p + 1] - offsets[p];
            const uint32_t* a = (nt == 1) ? sb
                : std::lower_bound(sb, sb + len, (uint32_t)s_lo);
            const uint32_t* b = (nt == 1 || s_hi >= S) ? sb + len
                : std::lower_bound(a, sb + len, (uint32_t)s_hi);
            const int64_t ln = b - a;
            if (ln == 0) continue;
            const int32_t* qq = pq_q + pq_off[p];
            const uint32_t* qc = pq_c + pq_off[p];
            // rough cycle model: AXPY ~sw/V per query + memset + row
            // fill, vs k*ln scalar scatters
            if (k >= 2 && k * (sw / V + 1) + sw / (V / 2) + ln < k * ln) {
                memset(row, 0, (size_t)sw * sizeof(T));
                for (int64_t j = 0; j < ln; ++j) row[a[j] - s_lo] = 1;
                const T* __restrict r = row;
                for (int64_t i = 0; i < k; ++i) {
                    T* __restrict o = acc + (size_t)qq[i] * S + s_lo;
                    const T c = (T)qc[i];
                    for (int64_t s = 0; s < sw; ++s)
                        o[s] = (T)(o[s] + c * r[s]);
                }
            } else {
                for (int64_t i = 0; i < k; ++i) {
                    T* o = acc + (size_t)qq[i] * S;
                    const T c = (T)qc[i];
                    for (int64_t j = 0; j < ln; ++j)
                        o[a[j]] = (T)(o[a[j]] + c);
                }
            }
        }
    });
}

void kmerdb_csr_apply_patmajor(
    int32_t n_queries, const int64_t* qoffs, const int64_t* ucnt,
    const int32_t* hit_pids, const uint32_t* hit_cnts,
    const int64_t* offsets, const uint32_t* sample_ids,
    int64_t n_patterns, int64_t n_samples, uint32_t* out) {
    const int64_t Q = n_queries, S = n_samples, P = n_patterns;
    if (Q == 0 || S == 0 || P == 0) return;
    int nt = kmerdb_get_threads();
    if (nt > 16) nt = 16;
    if (nt > S) nt = (int)S;
    int64_t H = 0;
    for (int64_t q = 0; q < Q; ++q) H += ucnt[q];
    if (H == 0) return;

    static void* pm_buf = nullptr;
    static size_t pm_cap = 0;
    // layout: pq_off i64[P+1] | cur i64[P] | pq_q i32[H] | pq_c u32[H]
    //         | row slices u32[nt*S] | u16 acc[Q*S] + rows u16[nt*S]
    const size_t need = (size_t)(P + 1) * 8 + (size_t)P * 8
        + (size_t)H * 8 + (size_t)nt * S * 4
        + ((size_t)Q * S + (size_t)nt * S) * 2;
    int64_t* pq_off = (int64_t*)arena_grow(&pm_buf, &pm_cap, need);
    if (!pq_off) {  // allocation failure: the query-major path still works
        kmerdb_csr_apply_many(n_queries, qoffs, ucnt, hit_pids, hit_cnts,
                              offsets, sample_ids, n_samples, out);
        return;
    }
    int64_t* cur = pq_off + P + 1;
    int32_t* pq_q = (int32_t*)(cur + P);
    uint32_t* pq_c = (uint32_t*)(pq_q + H);
    uint32_t* rows32 = pq_c + H;
    uint16_t* acc16 = (uint16_t*)(rows32 + (size_t)nt * S);
    uint16_t* rows16 = acc16 + (size_t)Q * S;

    // transpose the per-query hit lists to a pattern-major CSR; a
    // query's cell values are bounded by its total hit count, so the
    // same pass sizes the accumulator type
    memset(pq_off, 0, (size_t)(P + 1) * 8);
    uint64_t cell_bound = 0;
    for (int64_t q = 0; q < Q; ++q) {
        const int32_t* hp = hit_pids + qoffs[q];
        const uint32_t* hc = hit_cnts + qoffs[q];
        const int64_t u = ucnt[q];
        uint64_t qtot = 0;
        for (int64_t i = 0; i < u; ++i) {
            ++pq_off[hp[i] + 1];
            qtot += hc[i];
        }
        if (qtot > cell_bound) cell_bound = qtot;
    }
    for (int64_t p = 0; p < P; ++p) {
        pq_off[p + 1] += pq_off[p];
        cur[p] = pq_off[p];
    }
    for (int64_t q = 0; q < Q; ++q) {
        const int32_t* hp = hit_pids + qoffs[q];
        const uint32_t* hc = hit_cnts + qoffs[q];
        const int64_t u = ucnt[q];
        for (int64_t i = 0; i < u; ++i) {
            const int64_t w = cur[hp[i]]++;
            pq_q[w] = (int32_t)q;
            pq_c[w] = hc[i];
        }
    }

    if (cell_bound < 65536) {
        // u16 accumulation: half the memory traffic and twice the SIMD
        // lanes of the u32 path; widen once at the end
        memset(acc16, 0, (size_t)Q * S * 2);
        pm_apply<uint16_t>(nt, P, S, pq_off, pq_q, pq_c, offsets,
                           sample_ids, acc16, rows16);
        run_parallel(nt, [&](int t) {
            const int64_t lo = (int64_t)Q * S * t / nt;
            const int64_t hi = (int64_t)Q * S * (t + 1) / nt;
            for (int64_t i = lo; i < hi; ++i)
                out[i] += acc16[i];
        });
    } else {
        pm_apply<uint32_t>(nt, P, S, pq_off, pq_q, pq_c, offsets,
                           sample_ids, out, rows32);
    }
}

// cross-database variant: for every k-mer present in both sorted
// arrays, emit the (pattern-of-a, pattern-of-b) id pair (db2db_sp's
// per-bin sorted-merge, similarity_calculator.cpp:1252-1291)
int64_t kmerdb_intersect_probe(int64_t na, const uint64_t* ka,
                               const int32_t* pa, int64_t nb,
                               const uint64_t* kb, const int32_t* pb,
                               int32_t* out_a, int32_t* out_b) {
    int64_t pos = 0, h = 0;
    for (int64_t i = 0; i < na && pos < nb; ++i) {
        const uint64_t key = ka[i];
        int64_t lo = pos, step = 1;
        while (lo + step < nb && kb[lo + step] < key) {
            lo += step;
            step <<= 1;
        }
        int64_t hi = lo + step;
        if (hi > nb) hi = nb;
        const uint64_t* p = std::lower_bound(kb + lo, kb + hi, key);
        pos = p - kb;
        if (pos < nb && kb[pos] == key) {
            out_a[h] = pa[i];
            out_b[h] = pb[pos];
            ++h;
        }
    }
    return h;
}

// ---------------------------------------------------------------------------
// Dense incidence fill: B[rows[i], cols[i]] = 1 over a zeroed block
// (host-side build of the pattern-chunk incidence matrix consumed by
// the device Gram kernels; replaces a serialized on-device scatter)
// ---------------------------------------------------------------------------

void kmerdb_fill_incidence(int64_t n_el, const int32_t* rows,
                           const int32_t* cols, int64_t n_cols,
                           int8_t* out) {
    for (int64_t i = 0; i < n_el; ++i)
        out[(int64_t)rows[i] * n_cols + cols[i]] = 1;
}

// Bit-packed incidence fill straight from the pattern CSR, packed
// along the PATTERN axis: bit (i & 7) of byte (i >> 3, s) records
// pattern pids[i] containing sample s.  Packing cuts host->device
// transfer and host zeroing 8x versus byte incidence; the pattern-axis
// layout keeps the sample axis contiguous (the device step unpacks
// eight incidence rows per byte row, ops/gram.py unpack_bits).
void kmerdb_fill_incidence_bits(int64_t n, const int64_t* pids,
                                const int64_t* offs, const uint32_t* sids,
                                int64_t row_stride, uint8_t* out) {
    int nt = kmerdb_get_threads();
    if (nt > 16) nt = 16;
    if (nt <= 1 || n < (16 << 10)) {
        for (int64_t i = 0; i < n; ++i) {
            uint8_t* row = out + (i >> 3) * row_stride;
            uint8_t bit = (uint8_t)(1u << (i & 7));
            int64_t p = pids[i];
            for (int64_t j = offs[p]; j < offs[p + 1]; ++j)
                row[sids[j]] |= bit;
        }
        return;
    }
    // dynamic 8-ALIGNED chunks: eight consecutive i's share a packed
    // byte row, so chunk edges on multiples of 8 give each byte row to
    // exactly one thread (the |= RMW never races); dynamic stealing
    // rides out the ragged per-pattern CSR lengths
    const int64_t CH = 8 << 10;
    std::atomic<int64_t> next{0};
    run_parallel(nt, [&](int) {
        for (;;) {
            const int64_t c0 = next.fetch_add(CH);
            if (c0 >= n) break;
            const int64_t c1 = c0 + CH < n ? c0 + CH : n;
            for (int64_t i = c0; i < c1; ++i) {
                uint8_t* row = out + (i >> 3) * row_stride;
                uint8_t bit = (uint8_t)(1u << (i & 7));
                int64_t p = pids[i];
                for (int64_t j = offs[p]; j < offs[p + 1]; ++j)
                    row[sids[j]] |= bit;
            }
        }
    });
}

// Variant with explicit (non-consecutive) row indices: element i's
// bits land in packed row rows[i] instead of i.  Used by the parts
// grid, whose incidence rows are GLOBAL union k-mer coordinates with
// gaps where other parts own the k-mer.
void kmerdb_fill_incidence_bits_rows(int64_t n, const int64_t* rows,
                                     const int64_t* pids,
                                     const int64_t* offs,
                                     const uint32_t* sids,
                                     int64_t row_stride, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t r = rows[i];
        uint8_t* row = out + (r >> 3) * row_stride;
        uint8_t bit = (uint8_t)(1u << (r & 7));
        int64_t p = pids[i];
        for (int64_t j = offs[p]; j < offs[p + 1]; ++j)
            row[sids[j]] |= bit;
    }
}

// ---------------------------------------------------------------------------
// Pattern CSR fill
// ---------------------------------------------------------------------------
//
// For each pattern p: out[off[p] .. ] = old_sample_ids[old CSR slice of
// old_pid[p]] ++ uint32(merged_vals[rep_start[p]+skip .. +rep_len[p]]).
// skip = 1 when the representative group starts with an old-pattern ref
// (value >= ref_threshold).

void kmerdb_fill_csr(int64_t n_patterns, const int64_t* rep_start,
                     const uint64_t* rep_len, const uint32_t* merged_vals,
                     uint32_t ref_threshold, const int64_t* old_offsets,
                     const uint32_t* old_sample_ids, const int64_t* out_off,
                     uint32_t* out) {
    for (int64_t p = 0; p < n_patterns; ++p) {
        int64_t src = rep_start[p];
        int64_t len = (int64_t)rep_len[p];
        int64_t dst = out_off[p];
        if (len > 0 && merged_vals[src] >= ref_threshold) {
            int64_t old_pid = (int64_t)(merged_vals[src] - ref_threshold);
            int64_t lo = old_offsets[old_pid], hi = old_offsets[old_pid + 1];
            for (int64_t j = lo; j < hi; ++j) out[dst++] = old_sample_ids[j];
            ++src;
            --len;
        }
        for (int64_t j = 0; j < len; ++j)
            out[dst++] = merged_vals[src + j];
    }
}

// out_len per pattern (prefix-sum done by caller)
void kmerdb_csr_lengths(int64_t n_patterns, const int64_t* rep_start,
                        const uint64_t* rep_len, const uint32_t* merged_vals,
                        uint32_t ref_threshold, const int64_t* old_offsets,
                        int64_t* out_len) {
    for (int64_t p = 0; p < n_patterns; ++p) {
        int64_t src = rep_start[p];
        int64_t len = (int64_t)rep_len[p];
        if (len > 0 && merged_vals[src] >= ref_threshold) {
            int64_t old_pid = (int64_t)(merged_vals[src] - ref_threshold);
            len += old_offsets[old_pid + 1] - old_offsets[old_pid] - 1;
        }
        out_len[p] = len;
    }
}

// ---------------------------------------------------------------------------
// one2all accumulation: sims[sid] += count over pattern CSR slices
// (the reference's unrolled pattern-decode loop,
// similarity_calculator.cpp:737-794)
// ---------------------------------------------------------------------------

void kmerdb_csr_apply(int64_t n_hits, const int64_t* pids,
                      const uint32_t* counts, const int64_t* offsets,
                      const uint32_t* sample_ids, uint32_t* sims) {
    for (int64_t i = 0; i < n_hits; ++i) {
        const int64_t p = pids[i];
        const uint32_t c = counts[i];
        const int64_t lo = offsets[p], hi = offsets[p + 1];
        for (int64_t j = lo; j < hi; ++j) sims[sample_ids[j]] += c;
    }
}

// cross-database accumulation: C[r, c] += count for every (r, c) in
// pattern-pair slices (db2db_sp, similarity_calculator.cpp:1340-1529)
void kmerdb_cross_apply(int64_t n_pairs, const int64_t* p1,
                        const int64_t* p2, const uint32_t* counts,
                        const int64_t* off1, const uint32_t* sids1,
                        const int64_t* off2, const uint32_t* sids2,
                        int64_t n_cols, uint32_t* C) {
    for (int64_t i = 0; i < n_pairs; ++i) {
        const uint32_t cnt = counts[i];
        const int64_t a0 = off1[p1[i]], a1 = off1[p1[i] + 1];
        const int64_t b0 = off2[p2[i]], b1 = off2[p2[i] + 1];
        for (int64_t a = a0; a < a1; ++a) {
            uint32_t* row = C + (int64_t)sids1[a] * n_cols;
            for (int64_t b = b0; b < b1; ++b) row[sids2[b]] += cnt;
        }
    }
}


// ---------------------------------------------------------------------------
// Host all2all for small workloads (avoids a device round trip when
// sum(|set|^2) is tiny); same decomposition C += w_p * outer(b_p, b_p)
// ---------------------------------------------------------------------------

// Emits the lower triangle + diagonal only (sample ids within a
// pattern are ascending, so b <= a stays in-row ascending); the
// caller mirrors C afterwards.  Halves the scatter work of the full
// symmetric update.
//
// PRECONDITION: sids ascending within each pattern (the DB/group
// builders guarantee it; see models/database.py invariants).
//
// Large S: C (4*S^2 bytes) spills the cache and the random-row
// scatter drops ~10x (measured 2e10 -> 2e9 adds/s at S >= 2048).  The
// blocked form walks C one TILE x TILE sub-block at a time — every
// add lands in a cache-resident tile — re-slicing each pattern's
// ascending id list per block via precomputed cut offsets.  Exactness
// is free: uint32 adds commute, so any order gives identical bytes.
static void a2a_dense_blocked(int64_t n_patterns, const int64_t* offs,
                              const uint32_t* sids, const uint32_t* w,
                              int64_t n_samples, int64_t tile,
                              uint32_t* C) {
    const int64_t nb = (n_samples + tile - 1) / tile;
    // cuts[p*(nb+1)+k] = first index in [offs[p], offs[p+1]) with
    // sid >= k*tile (one linear pass; ids are ascending); patterns are
    // independent, so the precompute forks over pattern ranges
    std::vector<int64_t> cuts((size_t)n_patterns * (nb + 1));
    {
        int ct = kmerdb_get_threads();
        if (ct > 16) ct = 16;
        if (n_patterns < (16 << 10)) ct = 1;
        run_parallel(ct, [&](int t) {
            const int64_t p0 = n_patterns * t / ct;
            const int64_t p1 = n_patterns * (t + 1) / ct;
            for (int64_t p = p0; p < p1; ++p) {
                const int64_t hi = offs[p + 1];
                int64_t a = offs[p];
                int64_t* cp = cuts.data() + p * (nb + 1);
                for (int64_t k = 0; k < nb; ++k) {
                    const uint32_t bound = (uint32_t)(k * tile);
                    while (a < hi && sids[a] < bound) ++a;
                    cp[k] = a;
                }
                cp[nb] = hi;
            }
        });
    }
    // (bi, bj) tiles write disjoint C regions (rows from block bi,
    // columns from block bj), so the tile-pair list is embarrassingly
    // parallel; dynamic stealing balances the heavier diagonal tiles
    const int64_t n_pairs = nb * (nb + 1) / 2;
    int nt = kmerdb_get_threads();
    if (nt > 16) nt = 16;
    if ((int64_t)nt > n_pairs) nt = (int)n_pairs;
    std::atomic<int64_t> next{0};
    run_parallel(nt, [&](int) {
        for (;;) {
            const int64_t t = next.fetch_add(1);
            if (t >= n_pairs) break;
            // t-th lower-triangle pair: bi = largest with
            // bi*(bi+1)/2 <= t
            int64_t bi = (int64_t)((std::sqrt(8.0 * (double)t + 1.0)
                                    - 1.0) / 2.0);
            while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
            while (bi * (bi + 1) / 2 > t) --bi;
            const int64_t bj = t - bi * (bi + 1) / 2;
            for (int64_t p = 0; p < n_patterns; ++p) {
                const int64_t* cp = cuts.data() + p * (nb + 1);
                const int64_t i0 = cp[bi], i1 = cp[bi + 1];
                if (i0 == i1) continue;
                const uint32_t wp = w[p];
                if (bi == bj) {
                    for (int64_t a = i0; a < i1; ++a) {
                        uint32_t* row =
                            C + (int64_t)sids[a] * n_samples;
                        for (int64_t b = i0; b <= a; ++b)
                            row[sids[b]] += wp;
                    }
                } else {
                    const int64_t j0 = cp[bj], j1 = cp[bj + 1];
                    if (j0 == j1) continue;
                    for (int64_t a = i0; a < i1; ++a) {
                        uint32_t* row =
                            C + (int64_t)sids[a] * n_samples;
                        for (int64_t b = j0; b < j1; ++b)
                            row[sids[b]] += wp;
                    }
                }
            }
        }
    });
}

void kmerdb_a2a_dense(int64_t n_patterns, const int64_t* offs,
                      const uint32_t* sids, const uint32_t* w,
                      int64_t n_samples, uint32_t* C) {
    // blocked tier once C spills the fast cache (KMERDB_A2A_HOST_TILE
    // overrides; =0 forces the direct loop).  Measured S=4096 scale
    // DB, same session: direct 192 s; tile 512 -> 126 s (best), 256
    // -> 132, 1024 -> 146 — a 1.5x win, flat around 512 (this VM's
    // effective private cache is ~1 MB and the scalar add chain, not
    // C residency alone, bounds the rest)
    int64_t tile = 512;
    if (const char* e = getenv("KMERDB_A2A_HOST_TILE")) tile = atoll(e);
    if (tile > 0 && n_samples > tile) {
        a2a_dense_blocked(n_patterns, offs, sids, w, n_samples, tile, C);
        return;
    }
    for (int64_t p = 0; p < n_patterns; ++p) {
        const uint32_t wp = w[p];
        const int64_t lo = offs[p], hi = offs[p + 1];
        for (int64_t a = lo; a < hi; ++a) {
            uint32_t* row = C + (int64_t)sids[a] * n_samples;
            for (int64_t b = lo; b <= a; ++b) row[sids[b]] += wp;
        }
    }
}

// in-place symmetrize: C[i][j] and C[j][i] <- C[i][j] + C[j][i] for
// i != j (uint32 wraparound preserved)
void kmerdb_symmetrize_u32(int64_t n, uint32_t* C) {
    for (int64_t i = 1; i < n; ++i) {
        uint32_t* ri = C + i * n;
        for (int64_t j = 0; j < i; ++j) {
            const uint32_t t = ri[j] + C[j * n + i];
            ri[j] = t;
            C[j * n + i] = t;
        }
    }
}

// ---------------------------------------------------------------------------
// CSV row formatting (parity semantics of utils/num2str.py)
// ---------------------------------------------------------------------------

static inline char* put_u64(uint64_t v, char* out) {
    char tmp[20];
    int n = 0;
    do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (n) *out++ = tmp[--n];
    return out;
}

// dense row: "<v>," per value; returns bytes written
int64_t kmerdb_row_dense(const uint32_t* vals, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        p = put_u64(vals[i], p);
        *p++ = ',';
    }
    return p - out;
}

// explicit sparse pair row: "<col>:<v>," per element (cols already
// one-based and globally shifted — the all2all-parts row assembly,
// reference console_all2all_parts.cpp:294-315)
int64_t kmerdb_row_pairs(const int64_t* cols, const uint32_t* vals,
                         int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        p = put_u64((uint64_t)cols[i], p);
        *p++ = ':';
        p = put_u64(vals[i], p);
        *p++ = ',';
    }
    return p - out;
}

// sparse row: "<i+1>:<v>," per non-zero value
int64_t kmerdb_row_sparse(const uint32_t* vals, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        if (vals[i]) {
            p = put_u64((uint64_t)i + 1, p);
            *p++ = ':';
            p = put_u64(vals[i], p);
            *p++ = ',';
        }
    }
    return p - out;
}

// float row for the distance console: value = metric(common, q, db, k)
// with the exact Double2PChar(.,6) rendering; metric id selects the
// formula (utils/filters.py order).  Writes "<render>," per cell of a
// dense row; zero-valued metric renders "0" (num2str float semantics).
static inline char* put_double6(double val, char* out) {
    if (val == 0.0) { *out++ = '0'; return out; }
    if (val < 0) { *out++ = '-'; val = -val; }
    uint64_t x = (uint64_t)(val * 1000000.0 + 0.5);
    if (x < 1000000ULL) {
        *out++ = '0';
        *out++ = '.';
        char tmp[8];
        int n = 0;
        uint64_t v = x;
        do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
        for (int i = 0; i < 6 - n; ++i) *out++ = '0';
        while (n) *out++ = tmp[--n];
        return out;
    }
    char tmp[24];
    int n = 0;
    uint64_t v = x;
    do { tmp[n++] = (char)('0' + v % 10); v /= 10; } while (v);
    for (int i = n - 1; i >= 0; --i) {
        *out++ = tmp[i];
        if (i == 6) *out++ = '.';
    }
    return out;
}

int64_t kmerdb_row_double6(const double* vals, int64_t n, char delim,
                           char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        p = put_double6(vals[i], p);
        *p++ = delim;
    }
    return p - out;
}

// ---------------------------------------------------------------------------
// distance metrics (params.cpp:15-41 formulas; libm log == the
// reference's glibc log, which 6-decimal parity can hinge on)
// ---------------------------------------------------------------------------

enum {
    M_JACCARD = 0, M_MIN = 1, M_MAX = 2, M_COSINE = 3, M_MASH = 4,
    M_ANI = 5, M_ANI_SHORTER = 6, M_MASH_QUERY = 7, M_NUM_KMERS = 8,
};

static inline double eval_metric(int32_t metric, uint32_t common,
                                 uint32_t cnt1, uint32_t cnt2, int32_t k) {
    switch (metric) {
    case M_JACCARD:
        return (double)common / (uint32_t)(cnt1 + cnt2 - common);
    case M_MIN:
        return (double)common / (cnt1 < cnt2 ? cnt1 : cnt2);
    case M_MAX:
        return (double)common / (cnt1 > cnt2 ? cnt1 : cnt2);
    case M_COSINE:
        return (double)common / __builtin_sqrt((double)(uint32_t)(cnt1 * cnt2));
    case M_MASH: {
        double j = (double)common / (uint32_t)(cnt1 + cnt2 - common);
        if (j == 0) return 1.0;
        return (-1.0 / k) * __builtin_log((2 * j) / (j + 1));
    }
    case M_ANI: {
        double j = (double)common / (uint32_t)(cnt1 + cnt2 - common);
        double m = (j == 0) ? 1.0 : (-1.0 / k) * __builtin_log((2 * j) / (j + 1));
        return 1.0 - m;
    }
    case M_ANI_SHORTER: {
        double j = (double)common / (cnt1 < cnt2 ? cnt1 : cnt2);
        double m = (j == 0) ? 1.0 : (-1.0 / k) * __builtin_log((2 * j) / (j + 1));
        return 1.0 - m;
    }
    case M_MASH_QUERY: {
        double j = (double)common / cnt1;
        if (j == 0) return 1.0;
        return (-1.0 / k) * __builtin_log((2 * j) / (j + 1));
    }
    default:
        return (double)common;
    }
}

void kmerdb_metric_row(int32_t metric, const uint32_t* commons,
                       uint32_t query_cnt, const uint32_t* db_cnts,
                       int64_t n, int32_t k, double* out) {
    for (int64_t i = 0; i < n; ++i)
        out[i] = eval_metric(metric, commons[i], query_cnt, db_cnts[i], k);
}

// ---------------------------------------------------------------------------
// LEB128 varint codecs for the database container (io/dbfile.py).
//
// The bench hosts sustain only ~30-65 MB/s of file writeback, so the
// DB file size is directly build wall-clock; sorted k-mer arrays
// delta+varint to ~25% of raw and the id arrays to ~60%.  Encoders
// return bytes written; worst case is 10 bytes per u64 / 5 per u32
// (callers size the output buffer accordingly).
// ---------------------------------------------------------------------------

static inline uint8_t* vb_put(uint8_t* p, uint64_t v) {
    while (v >= 0x80) {
        *p++ = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    *p++ = (uint8_t)v;
    return p;
}

// fully unrolled decode: the generic shift-state loop pays a
// data-dependent branch AND two register updates per byte; unrolling
// makes each length a straight-line path whose single branch predicts
// well on real streams (delta widths cluster tightly), measured ~2x
// on the sorted-kmer delta streams this file serves
static inline const uint8_t* vb_get(const uint8_t* p, uint64_t* v) {
    uint64_t b = p[0];
    if (!(b & 0x80)) { *v = b; return p + 1; }
    uint64_t x = b & 0x7f;
    b = p[1]; x |= (b & 0x7f) << 7;
    if (!(b & 0x80)) { *v = x; return p + 2; }
    b = p[2]; x |= (b & 0x7f) << 14;
    if (!(b & 0x80)) { *v = x; return p + 3; }
    b = p[3]; x |= (b & 0x7f) << 21;
    if (!(b & 0x80)) { *v = x; return p + 4; }
    b = p[4]; x |= (b & 0x7f) << 28;
    if (!(b & 0x80)) { *v = x; return p + 5; }
    b = p[5]; x |= (b & 0x7f) << 35;
    if (!(b & 0x80)) { *v = x; return p + 6; }
    b = p[6]; x |= (b & 0x7f) << 42;
    if (!(b & 0x80)) { *v = x; return p + 7; }
    b = p[7]; x |= (b & 0x7f) << 49;
    if (!(b & 0x80)) { *v = x; return p + 8; }
    b = p[8]; x |= (b & 0x7f) << 56;
    if (!(b & 0x80)) { *v = x; return p + 9; }
    x |= (uint64_t)p[9] << 63;  // 10th byte: one significant bit
    *v = x; return p + 10;
}

// non-decreasing u64 stream -> varint deltas
int64_t kmerdb_vb_encode_delta_u64(int64_t n, const uint64_t* src,
                                   uint8_t* out) {
    uint8_t* p = out;
    uint64_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
        p = vb_put(p, src[i] - prev);
        prev = src[i];
    }
    return (int64_t)(p - out);
}

void kmerdb_vb_decode_delta_u64(int64_t n, const uint8_t* src,
                                uint64_t* out) {
    const uint8_t* p = src;
    uint64_t prev = 0, d;
    for (int64_t i = 0; i < n; ++i) {
        p = vb_get(p, &d);
        prev += d;
        out[i] = prev;
    }
}

// plain varints of a u32 stream (also used for delta-within-row
// streams whose deltas the caller prepares)
int64_t kmerdb_vb_encode_u32(int64_t n, const uint32_t* src, uint8_t* out) {
    uint8_t* p = out;
    for (int64_t i = 0; i < n; ++i) p = vb_put(p, src[i]);
    return (int64_t)(p - out);
}

void kmerdb_vb_decode_u32(int64_t n, const uint8_t* src, uint32_t* out) {
    const uint8_t* p = src;
    uint64_t v;
    for (int64_t i = 0; i < n; ++i) {
        p = vb_get(p, &v);
        out[i] = (uint32_t)v;
    }
}

}  // extern "C"
