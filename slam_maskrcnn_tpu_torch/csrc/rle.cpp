// COCO-compatible run-length-encoded mask codec — native core.
//
// Replacement for the reference's vendored pycocotools Cython/C
// extension (Mask_RCNN/pycocotools/_mask.pyx wrapping maskApi.c — see
// SURVEY §2.4(7)). Clean-room implementation from the COCO RLE format
// spec: runs alternate zeros/ones over the mask flattened in COLUMN-MAJOR
// order, first run counts zeros.
//
// Exposed as a plain C ABI for ctypes; eval/rle.py builds it with g++ into
// build/kernels/ at first use.
//
// Build by hand: g++ -O3 -shared -fPIC -o librle.so rle.cpp

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Encode a [h*w] uint8 mask (column-major layout expected by caller) into
// run counts. Returns number of runs written (<= h*w + 1).
int64_t rle_encode(const uint8_t* mask, int64_t n, uint32_t* counts,
                   int64_t max_counts) {
    int64_t ncounts = 0;
    uint8_t cur = 0;  // runs start with zeros
    int64_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v != cur) {
            if (ncounts >= max_counts) return -1;
            counts[ncounts++] = (uint32_t)run;
            cur = v;
            run = 0;
        }
        ++run;
    }
    if (ncounts >= max_counts) return -1;
    counts[ncounts++] = (uint32_t)run;
    return ncounts;
}

// Decode run counts into a [n] uint8 mask (column-major).
void rle_decode(const uint32_t* counts, int64_t ncounts, uint8_t* mask,
                int64_t n) {
    int64_t pos = 0;
    uint8_t val = 0;
    for (int64_t c = 0; c < ncounts && pos < n; ++c) {
        int64_t run = counts[c];
        if (run > n - pos) run = n - pos;
        memset(mask + pos, val, (size_t)run);
        pos += run;
        val ^= 1;
    }
}

uint64_t rle_area(const uint32_t* counts, int64_t ncounts) {
    uint64_t area = 0;
    for (int64_t c = 1; c < ncounts; c += 2) area += counts[c];
    return area;
}

// Merge two RLEs (union if intersect=0, intersection if 1) by a linear
// sweep over run boundaries. Returns run count, or -1 on overflow.
int64_t rle_merge(const uint32_t* a, int64_t na, const uint32_t* b,
                  int64_t nb, int intersect, uint32_t* out,
                  int64_t max_out) {
    int64_t ia = 0, ib = 0, nout = 0;
    uint64_t ra = na ? a[0] : 0, rb = nb ? b[0] : 0;
    uint8_t va = 0, vb = 0, vcur = 0;
    uint64_t run = 0;
    while (ia < na && ib < nb) {
        // advance past zero-length leading runs
        while (ia < na && ra == 0) {
            ++ia;
            if (ia < na) { ra = a[ia]; va ^= 1; }
        }
        while (ib < nb && rb == 0) {
            ++ib;
            if (ib < nb) { rb = b[ib]; vb ^= 1; }
        }
        if (ia >= na || ib >= nb) break;
        uint64_t step = ra < rb ? ra : rb;
        uint8_t v = intersect ? (va & vb) : (va | vb);
        if (v != vcur) {
            if (nout >= max_out) return -1;
            out[nout++] = (uint32_t)run;
            vcur = v;
            run = 0;
        }
        run += step;
        ra -= step;
        rb -= step;
    }
    if (nout >= max_out) return -1;
    out[nout++] = (uint32_t)run;
    return nout;
}

// Pairwise IoU between two RLE sets without decoding: intersection via a
// merged sweep; union = a1 + a2 - inter. iscrowd semantics: if crowd, the
// denominator is the area of the non-crowd (first) mask.
double rle_iou_pair(const uint32_t* a, int64_t na, const uint32_t* b,
                    int64_t nb, int iscrowd) {
    // intersection area via sweep
    int64_t ia = 0, ib = 0;
    uint64_t ra = na ? a[0] : 0, rb = nb ? b[0] : 0;
    uint8_t va = 0, vb = 0;
    uint64_t inter = 0;
    while (ia < na && ib < nb) {
        while (ia < na && ra == 0) {
            ++ia;
            if (ia < na) { ra = a[ia]; va ^= 1; }
        }
        while (ib < nb && rb == 0) {
            ++ib;
            if (ib < nb) { rb = b[ib]; vb ^= 1; }
        }
        if (ia >= na || ib >= nb) break;
        uint64_t step = ra < rb ? ra : rb;
        if (va && vb) inter += step;
        ra -= step;
        rb -= step;
    }
    uint64_t a1 = rle_area(a, na), a2 = rle_area(b, nb);
    double denom = iscrowd ? (double)a1 : (double)(a1 + a2 - inter);
    return denom > 0 ? (double)inter / denom : 0.0;
}

}  // extern "C"
