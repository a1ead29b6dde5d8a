/* Native entropy kernels: CABAC arithmetic engine + residual_coding
 * bin-stream generation.
 *
 * The runtime analog of the reference's hand-optimized entropy hot path
 * (x265 source/encoder/entropy.cpp encodeBin/codeCoeffNxN + the
 * scanPosLast/costCoeffNxN asm primitives): the TPU framework keeps
 * analysis/recon on-chip, and this C layer removes the host-side Python
 * cost of phase-1 (syntax -> bins) and phase-2 (bins -> bytes).
 *
 * Bit-exact contract: mirrors entropy/cabac.py (CabacEncoder) and
 * entropy/residual.py (encode_residual) exactly; parity enforced by
 * tests/test_native_entropy.py.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define CTX_BYPASS (-1)
#define CTX_TERM (-2)

/* ---------------------------------------------------------------- engine */

typedef struct {
    uint32_t low_hi;      /* we keep low in 64-bit to match python ints */
    uint64_t low;
    uint32_t range;
    int32_t bits_left;
    int32_t num_buffered;
    uint32_t buffered_byte;
    uint8_t *out;
    long out_len;
} Cabac;

static void put_byte(Cabac *c, uint32_t b) { c->out[c->out_len++] = (uint8_t)(b & 0xFF); }

static void write_out(Cabac *c)
{
    uint32_t lead = (uint32_t)(c->low >> (13 + c->bits_left));
    c->low &= (1ULL << (13 + c->bits_left)) - 1;
    c->bits_left -= 8;
    if (lead == 0xFF) {
        c->num_buffered++;
    } else {
        if (c->num_buffered > 0) {
            uint32_t carry = lead >> 8;
            put_byte(c, c->buffered_byte + carry);
            for (int i = 0; i < c->num_buffered - 1; i++)
                put_byte(c, 0xFF + carry);
        }
        c->num_buffered = 1;
        c->buffered_byte = lead & 0xFF;
    }
}

static void encode_bin(Cabac *c, int bin, uint8_t *state,
                       const uint8_t *lps_table, const uint8_t *next_state)
{
    uint32_t s = *state;
    *state = next_state[2 * s + bin];
    uint32_t rng = c->range;
    uint32_t lps = lps_table[4 * (s >> 1) + ((rng >> 6) & 3)];
    rng -= lps;
    if ((bin ^ (int)s) & 1) {
        int num_bits = 0;
        uint32_t v = lps;
        while (v) { num_bits++; v >>= 1; }
        num_bits = 9 - num_bits;
        c->low = (c->low + rng) << num_bits;
        c->range = lps << num_bits;
        c->bits_left += num_bits;
    } else {
        int shift = rng < 256 ? 1 : 0;
        c->low <<= shift;
        c->range = rng << shift;
        c->bits_left += shift;
    }
    if (c->bits_left >= 0)
        write_out(c);
}

static void encode_bin_ep(Cabac *c, int bin)
{
    c->low = (c->low << 1) + (bin ? c->range : 0);
    c->bits_left += 1;
    if (c->bits_left >= 0)
        write_out(c);
}

static void encode_bin_trm(Cabac *c, int bin)
{
    c->range -= 2;
    if (bin) {
        c->low = (c->low + c->range) << 7;
        c->range = 2 << 7;
        c->bits_left += 7;
    } else if (c->range >= 256) {
        return;
    } else {
        c->low <<= 1;
        c->range <<= 1;
        c->bits_left += 1;
    }
    if (c->bits_left >= 0)
        write_out(c);
}

/* Encode a bin-IR stream; returns output byte count.  tail[0]/tail[1] =
 * the final partial-bit value/count to append after the bytes (the
 * python side writes them into its BitWriter before rbsp trailing). */
long cabac_encode(const uint8_t *bins, const int32_t *ctx, long n,
                  uint8_t *states, const uint8_t *lps_table,
                  const uint8_t *next_state, uint8_t *out, int64_t *tail)
{
    Cabac c;
    memset(&c, 0, sizeof(c));
    c.range = 510;
    c.bits_left = -12;
    c.buffered_byte = 0xFF;
    c.out = out;
    c.out_len = 0;
    for (long i = 0; i < n; i++) {
        int32_t cx = ctx[i];
        int b = bins[i];
        if (cx == CTX_BYPASS)
            encode_bin_ep(&c, b);
        else if (cx == CTX_TERM)
            encode_bin_trm(&c, b);
        else
            encode_bin(&c, b, &states[cx], lps_table, next_state);
    }
    /* finish (mirrors CabacEncoder.finish) */
    if (c.low >> (21 + c.bits_left)) {
        put_byte(&c, c.buffered_byte + 1);
        for (int i = 0; i < c.num_buffered - 1; i++)
            put_byte(&c, 0x00);
        c.low -= 1ULL << (21 + c.bits_left);
    } else {
        if (c.num_buffered > 0)
            put_byte(&c, c.buffered_byte);
        for (int i = 0; i < c.num_buffered - 1; i++)
            put_byte(&c, 0xFF);
    }
    int nbits = 13 + c.bits_left;
    tail[0] = (int64_t)(c.low >> 8);
    tail[1] = nbits;
    return c.out_len;
}

/* Advance context states over a bin-IR without arithmetic coding (WPP
 * context-sync computation: the state after CTU 1 of a row seeds the row
 * below, reference entropy ctx save/restore frameencoder.cpp:1666). */
void advance_states(const uint8_t *bins, const int32_t *ctx, long n,
                    uint8_t *states, const uint8_t *next_state)
{
    for (long i = 0; i < n; i++) {
        int32_t c = ctx[i];
        if (c >= 0)
            states[c] = next_state[2 * states[c] + bins[i]];
    }
}

/* ------------------------------------------------- residual bin-stream */

typedef struct {
    uint8_t *bins;
    int32_t *ctx;
    long n;
} IR;

static void cbin(IR *ir, int b, int32_t c) { ir->bins[ir->n] = (uint8_t)b; ir->ctx[ir->n++] = c; }
static void bypass(IR *ir, int b) { cbin(ir, b, CTX_BYPASS); }
static void bypass_bits(IR *ir, uint32_t v, int n)
{
    for (int k = n - 1; k >= 0; k--)
        bypass(ir, (v >> k) & 1);
}

static const int32_t CTX_IDX_MAP_4x4[16] =
    {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};

static int group_idx(int pos)
{
    if (pos < 4) return pos;
    int k = 31 - __builtin_clz((unsigned)pos);
    return 2 * k + ((pos >> (k - 1)) & 1);
}

static int min_in_group(int g)
{
    if (g < 4) return g;
    return (2 + (g & 1)) << ((g >> 1) - 1);
}

/* offsets array layout (from contexts.OFF, passed by python):
 * [0]=SIG_CG [1]=SIG [2]=LAST_X [3]=LAST_Y [4]=ONE [5]=ABS */
enum { O_SIG_CG, O_SIG, O_LAST_X, O_LAST_Y, O_ONE, O_ABS };

static void write_last_prefix(IR *ir, int pos, int log2_tb, int c_idx,
                              int base_ctx)
{
    int g = group_idx(pos);
    int ctx_offset, ctx_shift;
    if (c_idx == 0) {
        ctx_offset = 3 * (log2_tb - 2) + ((log2_tb - 1) >> 2);
        ctx_shift = (log2_tb + 1) >> 2;
    } else {
        ctx_offset = 15;
        ctx_shift = log2_tb - 2;
    }
    int cmax = (log2_tb << 1) - 1;
    for (int b = 0; b < g; b++)
        cbin(ir, 1, base_ctx + ctx_offset + (b >> ctx_shift));
    if (g < cmax)
        cbin(ir, 0, base_ctx + ctx_offset + (g >> ctx_shift));
}

static int sig_ctx(int xc, int yc, int cgx, int cgy, const uint8_t *cg_map,
                   int cg_grid, int log2_tb, int c_idx, int scan_idx,
                   const int32_t *off)
{
    int base = off[O_SIG] + (c_idx ? 27 : 0);
    if (log2_tb == 2)
        return base + CTX_IDX_MAP_4x4[(yc << 2) + xc];
    if (xc == 0 && yc == 0)
        return base;
    int right = (cgx + 1 < cg_grid) ? cg_map[cgy * cg_grid + cgx + 1] : 0;
    int below = (cgy + 1 < cg_grid) ? cg_map[(cgy + 1) * cg_grid + cgx] : 0;
    int prev = (right ? 1 : 0) | (below ? 2 : 0);
    int xp = xc & 3, yp = yc & 3;
    int s;
    switch (prev) {
    case 0: s = (xp + yp == 0) ? 2 : (xp + yp < 3) ? 1 : 0; break;
    case 1: s = (yp == 0) ? 2 : (yp == 1) ? 1 : 0; break;
    case 2: s = (xp == 0) ? 2 : (xp == 1) ? 1 : 0; break;
    default: s = 2;
    }
    if (c_idx == 0 && (cgx || cgy))
        s += 3;
    if (log2_tb == 3)
        s += (c_idx == 0) ? ((scan_idx == 0) ? 9 : 15) : 9;
    else
        s += (c_idx == 0) ? 21 : 12;
    return base + s;
}

static void write_remaining(IR *ir, int value, int rice)
{
    if (value < (3 << rice)) {
        int length = value >> rice;
        for (int i = 0; i < length; i++)
            bypass(ir, 1);
        bypass(ir, 0);
        bypass_bits(ir, value & ((1 << rice) - 1), rice);
    } else {
        int length = rice;
        value -= 3 << rice;
        while (value >= (1 << length)) {
            value -= 1 << length;
            length++;
        }
        int nb = 3 + length + 1 - rice;
        bypass_bits(ir, (1u << nb) - 2, nb);
        bypass_bits(ir, (uint32_t)value, length);
    }
}

/* Append the residual_coding bins of one TB.
 * level:   n*n raster int32
 * scan_xy: (n*n, 2) x,y pairs in scan order
 * cg_xy:   (ncg, 2)
 * Returns the number of bins appended. */
long enc_residual(const int32_t *level, int log2_tb, int c_idx,
                  int scan_idx, int sign_hide, const int32_t *scan_xy,
                  const int32_t *cg_xy, const int32_t *off,
                  uint8_t *bins_out, int32_t *ctx_out)
{
    IR ir = {bins_out, ctx_out, 0};
    int n = 1 << log2_tb;
    int ncoef = n * n;
    int32_t lev_scan[1024];
    int last_scan_pos = -1;
    for (int i = 0; i < ncoef; i++) {
        int x = scan_xy[2 * i], y = scan_xy[2 * i + 1];
        lev_scan[i] = level[y * n + x];
        if (lev_scan[i])
            last_scan_pos = i;
    }
    if (last_scan_pos < 0)
        return 0; /* caller checks cbf */
    int lx = scan_xy[2 * last_scan_pos];
    int ly = scan_xy[2 * last_scan_pos + 1];
    if (scan_idx == 2) { int t = lx; lx = ly; ly = t; }
    write_last_prefix(&ir, lx, log2_tb, c_idx, off[O_LAST_X]);
    write_last_prefix(&ir, ly, log2_tb, c_idx, off[O_LAST_Y]);
    int gg[2] = {lx, ly};
    for (int i = 0; i < 2; i++) {
        int g = group_idx(gg[i]);
        if (g > 3)
            bypass_bits(&ir, (uint32_t)(gg[i] - min_in_group(g)),
                        (g >> 1) - 1);
    }

    int last_cg = last_scan_pos >> 4;
    int cg_grid = (n >> 2) > 0 ? (n >> 2) : 1;
    uint8_t cg_map[64];
    memset(cg_map, 0, sizeof(cg_map));
    int c1 = 1;
    for (int i = last_cg; i >= 0; i--) {
        int cgx = cg_xy[2 * i], cgy = cg_xy[2 * i + 1];
        int infer_dc_sig = 0;
        int cg_has = 0;
        for (int p = 0; p < 16; p++)
            if (lev_scan[i * 16 + p]) { cg_has = 1; break; }
        if (i == last_cg || i == 0) {
            cg_map[cgy * cg_grid + cgx] = 1;
        } else {
            int right = (cgx + 1 < cg_grid) ? cg_map[cgy * cg_grid + cgx + 1] : 0;
            int below = (cgy + 1 < cg_grid) ? cg_map[(cgy + 1) * cg_grid + cgx] : 0;
            int cx = off[O_SIG_CG] + (c_idx ? 2 : 0) + ((right || below) ? 1 : 0);
            cbin(&ir, cg_has, cx);
            infer_dc_sig = cg_has;
            cg_map[cgy * cg_grid + cgx] = (uint8_t)cg_has;
            if (!cg_has)
                continue;
        }
        const int32_t *in_cg = &lev_scan[i * 16];
        int last_pos_in_cg = (i < last_cg) ? 15 : (last_scan_pos - i * 16);

        int sig_positions[16];
        int num_nz = 0;
        int sig_coded_one = 0;
        for (int p = last_pos_in_cg; p >= 0; p--) {
            int is_last = (i == last_cg && p == last_pos_in_cg);
            int sig = in_cg[p] != 0;
            if (is_last) {
                sig_positions[num_nz++] = p;
                sig_coded_one = 1;
                continue;
            }
            if (p == 0 && infer_dc_sig && !sig_coded_one) {
                sig_positions[num_nz++] = p;
                break;
            }
            int xc = scan_xy[2 * (i * 16 + p)];
            int yc = scan_xy[2 * (i * 16 + p) + 1];
            cbin(&ir, sig, sig_ctx(xc, yc, cgx, cgy, cg_map, cg_grid,
                                   log2_tb, c_idx, scan_idx, off));
            if (sig) {
                sig_positions[num_nz++] = p;
                sig_coded_one = 1;
            }
        }
        if (num_nz == 0)
            continue;
        int64_t abs_lv[16];
        int signs[16];
        for (int k = 0; k < num_nz; k++) {
            int32_t v = in_cg[sig_positions[k]];
            abs_lv[k] = v < 0 ? -(int64_t)v : v;
            signs[k] = v < 0;
        }
        int ctx_set = ((i > 0 && c_idx == 0) ? 2 : 0) + (c1 == 0 ? 1 : 0);
        c1 = 1;
        int g1_base = off[O_ONE] + (c_idx ? 16 : 0) + 4 * ctx_set;
        int first_g2 = -1;
        int num_g1 = num_nz < 8 ? num_nz : 8;
        for (int k = 0; k < num_g1; k++) {
            int flag = abs_lv[k] > 1;
            cbin(&ir, flag, g1_base + c1);
            if (flag) {
                c1 = 0;
                if (first_g2 == -1)
                    first_g2 = k;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        if (first_g2 != -1)
            cbin(&ir, abs_lv[first_g2] > 2,
                 off[O_ABS] + (c_idx ? 4 : 0) + ctx_set);

        int first_sig_scan = sig_positions[num_nz - 1];
        int last_sig_scan = sig_positions[0];
        int hidden = sign_hide && (last_sig_scan - first_sig_scan >= 4);
        int n_signs = hidden ? num_nz - 1 : num_nz;
        for (int k = 0; k < n_signs; k++)
            bypass(&ir, signs[k]);

        int rice = 0;
        for (int k = 0; k < num_nz; k++) {
            int base_level = 1;
            if (k < 8) {
                base_level = 2;
                if (k == first_g2)
                    base_level = 3;
            }
            if (abs_lv[k] >= base_level) {
                write_remaining(&ir, (int)(abs_lv[k] - base_level), rice);
                if (abs_lv[k] > (3 << rice))
                    rice = rice < 4 ? rice + 1 : 4;
            }
        }
    }
    return ir.n;
}

/* ---------------------------------------- slice-level merged residuals */

/* Merge a python-generated syntax bin-IR with deferred residual TUs in
 * ONE call (the "one native call per slice" entropy path: kills the
 * per-TU ctypes dispatch that dominated host time; analog of the
 * reference coding the whole CTU row inside Entropy::encodeCTU).
 *
 * py_bins/py_ctx: python syntax bins (n_py of them).
 * tu_desc: ntu * 6 int32: [pos_in_py_stream, lev_off, log2_tb, c_idx,
 *          scan_idx, sign_hide], pos non-decreasing.
 * levels:  staging buffer; TU t's raster levels at lev_off..+n*n.
 * scan_blob + scan_offs: scan_offs[(log2-2)*6 + scan*2 + {0,1}] are
 *          int32-element offsets of scan_xy / cg_xy in scan_blob.
 * tu_counts: out, per-TU appended bin counts (for WPP sync marks).
 * Returns total merged bin count. */
long merge_residual_ir(const uint8_t *py_bins, const int32_t *py_ctx,
                       long n_py, const int32_t *tu_desc, long ntu,
                       const int32_t *levels, const int32_t *scan_blob,
                       const int32_t *scan_offs, const int32_t *off,
                       uint8_t *out_bins, int32_t *out_ctx,
                       int32_t *tu_counts)
{
    long src = 0, dst = 0;
    for (long t = 0; t < ntu; t++) {
        const int32_t *d = &tu_desc[6 * t];
        long pos = d[0];
        long seg = pos - src;
        if (seg > 0) {
            memcpy(&out_bins[dst], &py_bins[src], (size_t)seg);
            memcpy(&out_ctx[dst], &py_ctx[src], (size_t)seg * 4);
            src += seg;
            dst += seg;
        }
        int log2_tb = d[2];
        int so = (log2_tb - 2) * 6 + d[4] * 2;
        long cnt = enc_residual(&levels[d[1]], log2_tb, d[3], d[4], d[5],
                                &scan_blob[scan_offs[so]],
                                &scan_blob[scan_offs[so + 1]], off,
                                &out_bins[dst], &out_ctx[dst]);
        tu_counts[t] = (int32_t)cnt;
        dst += cnt;
    }
    if (n_py > src) {
        memcpy(&out_bins[dst], &py_bins[src], (size_t)(n_py - src));
        memcpy(&out_ctx[dst], &py_ctx[src], (size_t)(n_py - src) * 4);
        dst += n_py - src;
    }
    return dst;
}

/* emulation_prevention_three_byte insertion (spec 7.4.2): any
 * 00 00 0x (x<=3) run in the RBSP becomes 00 00 03 0x.  out must hold
 * n + n/2 bytes (worst case).  Returns the escaped length. */
long anti_emulation(const unsigned char *in, long n, unsigned char *out)
{
    long o = 0;
    int zeros = 0;
    for (long i = 0; i < n; i++) {
        unsigned char b = in[i];
        if (zeros >= 2 && b <= 3) {
            out[o++] = 3;
            zeros = 0;
        }
        out[o++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    return o;
}

/* ------------------------------------------------------- intra walker */
/* Full intra-slice phase-1 walk in C: coding_quadtree + intra CU syntax
 * + transform_tree + inline residual bins (the native analog of
 * entropy/cu_syntax.py SliceSyntaxEncoder for the common all-intra
 * configuration: 4:2:0, min CU 16, 2Nx2N PUs, chroma DM, optional
 * 32x32 CUs via the tree (TU32) or legacy same-mode merge, optional
 * cu_qp_delta and SAO).  Python falls back to the reference walker for
 * anything else; parity enforced by tests/test_intra_walker.py. */

typedef struct {
    /* geometry */
    int width, height, nbx, nby, rbx, n_ctu_x, n_ctu_y, log2_ctu;
    int log2_max_tu, max_td_intra, tree, legacy_merge, log2_min_cu;
    int dqp_enabled, sync, wpp_terms, slice_qp, bit_depth, sign_hide;
    /* inputs */
    const int32_t *modes;
    const uint8_t *split32;
    const int32_t *mode32;
    const uint8_t *nzy, *nzu, *nzv;
    const int32_t *lvy, *lvu, *lvv;
    const int32_t *qp_map;
    const int32_t *sao;        /* n_ctu*3*7: type,eo,band,o0..o3 */
    const int32_t *sao_merge;  /* n_ctu */
    const int32_t *sxy16, *cg16, *sxy8, *cg8, *sxy32, *cg32;
    const int32_t *roff;       /* residual ctx offsets */
    const int32_t *coff;       /* CU-level ctx offsets, see CO_* */
    /* state */
    int8_t *mode16, *depth16;  /* nby*nbx neighbor maps, -1 = unset */
    int qp_prev, qg_pred, cur_qp, dqp_coded;
    IR ir;
    long cap;
} IW;

enum { CO_SPLIT, CO_PART, CO_ADI, CO_CHROMA, CO_DQP, CO_QT_CBF,
       CO_SUBDIV, CO_SAO_MERGE, CO_SAO_TYPE };

static int iw_mode_at(IW *w, int x, int y)
{
    if (x < 0 || y < 0 || x >= w->width || y >= w->height)
        return -1;
    return w->mode16[(y >> 4) * w->nbx + (x >> 4)];
}

static int iw_depth_at(IW *w, int x, int y)
{
    if (x < 0 || y < 0 || x >= w->width || y >= w->height)
        return -1;
    return w->depth16[(y >> 4) * w->nbx + (x >> 4)];
}

static void iw_set_area(int8_t *map, int nbx, int x0, int y0, int log2,
                        int v)
{
    int n = 1 << (log2 - 4);
    for (int dy = 0; dy < n; dy++)
        for (int dx = 0; dx < n; dx++)
            map[((y0 >> 4) + dy) * nbx + (x0 >> 4) + dx] = (int8_t)v;
}

static void iw_eg0(IW *w, int v)
{
    int k = 0;
    while (v >= (1 << k)) {
        bypass(&w->ir, 1);
        v -= 1 << k;
        k++;
    }
    bypass(&w->ir, 0);
    bypass_bits(&w->ir, (uint32_t)v, k);
}

static void iw_dqp(IW *w)
{
    int delta = w->cur_qp - w->qg_pred;
    int a = delta < 0 ? -delta : delta;
    int prefix = a < 5 ? a : 5;
    cbin(&w->ir, prefix > 0, w->coff[CO_DQP]);
    for (int k = 1; k < prefix; k++)
        cbin(&w->ir, 1, w->coff[CO_DQP] + 1);
    if (prefix > 0 && prefix < 5)
        cbin(&w->ir, 0, w->coff[CO_DQP] + 1);
    if (a >= 5)
        iw_eg0(w, a - 5);
    if (a)
        bypass(&w->ir, delta < 0);
    w->dqp_coded = 1;
}

/* cbf over the 16-block grid region of a CU/TU */
static int iw_nz(const uint8_t *nz, int nbx, int bx, int by, int nb)
{
    for (int dy = 0; dy < nb; dy++)
        for (int dx = 0; dx < nb; dx++)
            if (nz[(by + dy) * nbx + bx + dx])
                return 1;
    return 0;
}

static void iw_residual(IW *w, const int32_t *level, int log2_tb,
                        int c_idx)
{
    const int32_t *sxy = log2_tb == 3 ? w->sxy8 :
                         log2_tb == 4 ? w->sxy16 : w->sxy32;
    const int32_t *cg = log2_tb == 3 ? w->cg8 :
                        log2_tb == 4 ? w->cg16 : w->cg32;
    long n = enc_residual(level, log2_tb, c_idx, 0, w->sign_hide, sxy,
                          cg, w->roff, w->ir.bins + w->ir.n,
                          w->ir.ctx + w->ir.n);
    w->ir.n += n;
}

/* gather a 2x2 group of 16-block TBs into one contiguous TB */
static void iw_gather4(const int32_t *src, int nbx, int bx, int by,
                       int bn, int32_t *dst)
{
    int sz = bn * bn;
    for (int q = 0; q < 4; q++) {
        const int32_t *s = src + (long)((by + (q >> 1)) * nbx + bx +
                                        (q & 1)) * sz;
        int32_t *d = dst + (q >> 1) * bn * 2 * bn + (q & 1) * bn;
        for (int r = 0; r < bn; r++)
            memcpy(d + r * 2 * bn, s + r * bn, (size_t)bn * 4);
    }
}

static void iw_tt(IW *w, int x0, int y0, int log2, int td, int pcb,
                  int pcr)
{
    int bx = x0 >> 4, by = y0 >> 4, nb = 1 << (log2 - 4);
    int can_split = (log2 <= w->log2_max_tu && log2 > 2 &&
                     td < w->max_td_intra);
    int split = log2 > w->log2_max_tu;
    if (can_split)
        cbin(&w->ir, split, w->coff[CO_SUBDIV] + 5 - log2);
    int cbf_cb = iw_nz(w->nzu, w->nbx, bx, by, nb);
    int cbf_cr = iw_nz(w->nzv, w->nbx, bx, by, nb);
    if (pcb)
        cbin(&w->ir, cbf_cb, w->coff[CO_QT_CBF] + 2 + td);
    if (pcr)
        cbin(&w->ir, cbf_cr, w->coff[CO_QT_CBF] + 2 + td);
    if (split) {
        int half = 1 << (log2 - 1);
        iw_tt(w, x0, y0, log2 - 1, td + 1, cbf_cb, cbf_cr);
        iw_tt(w, x0 + half, y0, log2 - 1, td + 1, cbf_cb, cbf_cr);
        iw_tt(w, x0, y0 + half, log2 - 1, td + 1, cbf_cb, cbf_cr);
        iw_tt(w, x0 + half, y0 + half, log2 - 1, td + 1, cbf_cb,
              cbf_cr);
        return;
    }
    int cbf_luma = iw_nz(w->nzy, w->nbx, bx, by, nb);
    cbin(&w->ir, cbf_luma, w->coff[CO_QT_CBF] + (td == 0 ? 1 : 0));
    if (!(cbf_luma || cbf_cb || cbf_cr))
        return;
    if (w->dqp_enabled && !w->dqp_coded)
        iw_dqp(w);
    int32_t tmp[1024];
    if (cbf_luma) {
        if (log2 == 4) {
            iw_residual(w, w->lvy + (long)(by * w->nbx + bx) * 256, 4,
                        0);
        } else {
            iw_gather4(w->lvy, w->nbx, bx, by, 16, tmp);
            iw_residual(w, tmp, 5, 0);
        }
    }
    const int32_t *lvc[2] = {w->lvu, w->lvv};
    int cbfc[2] = {cbf_cb, cbf_cr};
    for (int c = 0; c < 2; c++) {
        if (!cbfc[c])
            continue;
        if (log2 == 4) {
            iw_residual(w, lvc[c] + (long)(by * w->nbx + bx) * 64, 3,
                        c + 1);
        } else {
            iw_gather4(lvc[c], w->nbx, bx, by, 8, tmp);
            iw_residual(w, tmp, 4, c + 1);
        }
    }
}

static void iw_cu(IW *w, int x0, int y0, int log2)
{
    int mode;
    if (log2 == 5) {
        int rx = x0 >> 5, ry = y0 >> 5;
        mode = w->tree ? w->mode32[ry * w->rbx + rx]
                       : w->modes[(y0 >> 4) * w->nbx + (x0 >> 4)];
    } else {
        mode = w->modes[(y0 >> 4) * w->nbx + (x0 >> 4)];
    }
    if (log2 == w->log2_min_cu)
        cbin(&w->ir, 1, w->coff[CO_PART]);   /* PART_2Nx2N at min CU */
    int a = iw_mode_at(w, x0 - 1, y0);
    if (a < 0)
        a = 1;
    int b;
    if (y0 == 0 || ((y0 - 1) >> w->log2_ctu) != (y0 >> w->log2_ctu))
        b = 1;
    else {
        b = iw_mode_at(w, x0, y0 - 1);
        if (b < 0)
            b = 1;
    }
    int mpm[3];
    if (a == b) {
        if (a < 2) {
            mpm[0] = 0; mpm[1] = 1; mpm[2] = 26;
        } else {
            mpm[0] = a;
            mpm[1] = 2 + ((a + 29) % 32);
            mpm[2] = 2 + ((a - 1) % 32);
        }
    } else {
        mpm[0] = a;
        mpm[1] = b;
        if (a != 0 && b != 0)
            mpm[2] = 0;
        else if (a != 1 && b != 1)
            mpm[2] = 1;
        else
            mpm[2] = 26;
    }
    int idx = mode == mpm[0] ? 0 : mode == mpm[1] ? 1 :
              mode == mpm[2] ? 2 : -1;
    cbin(&w->ir, idx >= 0, w->coff[CO_ADI]);
    iw_set_area(w->mode16, w->nbx, x0, y0, log2, mode);
    if (idx >= 0) {
        bypass(&w->ir, idx != 0);
        if (idx)
            bypass(&w->ir, idx - 1);
    } else {
        int rem = mode;
        for (int k = 0; k < 3; k++)
            if (mode > mpm[k])
                rem--;
        bypass_bits(&w->ir, (uint32_t)rem, 5);
    }
    cbin(&w->ir, 0, w->coff[CO_CHROMA]);     /* chroma DM */
    iw_tt(w, x0, y0, log2, 0, 1, 1);
}

/* does a CU of this size sit at (x0, y0)?  (mirrors build_region) */
static int iw_cu32_here(IW *w, int x0, int y0)
{
    if (x0 + 32 > w->width || y0 + 32 > w->height)
        return 0;
    int rx = x0 >> 5, ry = y0 >> 5;
    if (w->tree)
        return w->split32 && !w->split32[ry * w->rbx + rx];
    if (w->legacy_merge) {
        int bx = 2 * rx, by = 2 * ry;
        int32_t m = w->modes[by * w->nbx + bx];
        return w->modes[by * w->nbx + bx + 1] == m &&
               w->modes[(by + 1) * w->nbx + bx] == m &&
               w->modes[(by + 1) * w->nbx + bx + 1] == m;
    }
    return 0;
}

static void iw_qt(IW *w, int x0, int y0, int log2, int depth)
{
    int size = 1 << log2;
    int inside = (x0 + size <= w->width && y0 + size <= w->height);
    int is_cu = inside &&
        (log2 == 4 || (log2 == 5 && iw_cu32_here(w, x0, y0)));
    int split = !is_cu;
    if (inside && log2 > w->log2_min_cu) {
        int ctx = w->coff[CO_SPLIT] +
            (iw_depth_at(w, x0 - 1, y0) > depth) +
            (iw_depth_at(w, x0, y0 - 1) > depth);
        cbin(&w->ir, split, ctx);
    }
    if (split || !inside) {
        int half = 1 << (log2 - 1);
        for (int q = 0; q < 4; q++) {
            int x = x0 + (q & 1) * half, y = y0 + (q >> 1) * half;
            if (x < w->width && y < w->height)
                iw_qt(w, x, y, log2 - 1, depth + 1);
        }
        return;
    }
    iw_set_area(w->depth16, w->nbx, x0, y0, log2, depth);
    iw_cu(w, x0, y0, log2);
}

static void iw_sao_offset_abs(IW *w, int v, int cmax)
{
    for (int k = 0; k < v; k++)
        bypass(&w->ir, 1);
    if (v < cmax)
        bypass(&w->ir, 0);
}

static void iw_sao_type(IW *w, int t)
{
    cbin(&w->ir, t > 0, w->coff[CO_SAO_TYPE]);
    if (t > 0)
        bypass(&w->ir, t == 2);
}

static void iw_sao(IW *w, int cx, int cy)
{
    long ci = (long)(cy * w->n_ctu_x + cx);
    int merge = w->sao_merge ? w->sao_merge[ci] : 0;
    if (cx > 0)
        cbin(&w->ir, merge == 1, w->coff[CO_SAO_MERGE]);
    if (cy > 0 && merge != 1)
        cbin(&w->ir, merge == 2, w->coff[CO_SAO_MERGE]);
    if (merge)
        return;
    int bd = w->bit_depth < 10 ? w->bit_depth : 10;
    int cmax = (1 << (bd - 5)) - 1;
    for (int c = 0; c < 3; c++) {
        const int32_t *pr = w->sao + ci * 21 + c * 7;
        int type = pr[0];
        if (c == 0)
            iw_sao_type(w, type);
        else if (c == 1)
            iw_sao_type(w, type);
        if (type == 0)
            continue;
        for (int k = 0; k < 4; k++) {
            int o = pr[3 + k];
            iw_sao_offset_abs(w, o < 0 ? -o : o, cmax);
        }
        if (type == 1) {                     /* band */
            for (int k = 0; k < 4; k++)
                if (pr[3 + k] != 0)
                    bypass(&w->ir, pr[3 + k] < 0);
            bypass_bits(&w->ir, (uint32_t)pr[2], 5);
        } else if (c == 0 || c == 1) {
            bypass_bits(&w->ir, (uint32_t)pr[1], 2);
        }
    }
}

long intra_slice_bins(const int32_t *prm, const int32_t *modes,
                      const uint8_t *split32, const int32_t *mode32,
                      const uint8_t *nzy, const uint8_t *nzu,
                      const uint8_t *nzv, const int32_t *lvy,
                      const int32_t *lvu, const int32_t *lvv,
                      const int32_t *qp_map, const int32_t *sao,
                      const int32_t *sao_merge, const int32_t *scan_blob,
                      const int32_t *scan_offs, const int32_t *roff,
                      const int32_t *coff, int8_t *mode16,
                      int8_t *depth16, int32_t *state,
                      uint8_t *out_bins, int32_t *out_ctx, long cap,
                      int64_t *out_mark)
{
    IW w;
    memset(&w, 0, sizeof(w));
    w.width = prm[0]; w.height = prm[1];
    w.nbx = prm[2]; w.nby = prm[3];
    w.n_ctu_x = prm[4]; w.n_ctu_y = prm[5];
    w.log2_ctu = prm[6]; w.log2_max_tu = prm[7];
    w.max_td_intra = prm[8]; w.tree = prm[9];
    w.dqp_enabled = prm[10]; w.slice_qp = prm[11];
    w.sync = prm[12]; w.bit_depth = prm[15]; w.sign_hide = prm[16];
    w.legacy_merge = prm[17]; w.wpp_terms = prm[18];
    w.log2_min_cu = prm[19];
    int cy0 = prm[13], cy1 = prm[14];
    /* split32/mode32 row stride: regions fully inside the picture only
     * (n32x = floor(nbx/2)); a ceil stride mis-reads every row past the
     * first when the width is an odd multiple of 16 */
    w.rbx = w.nbx >> 1;
    w.modes = modes; w.split32 = split32; w.mode32 = mode32;
    w.nzy = nzy; w.nzu = nzu; w.nzv = nzv;
    w.lvy = lvy; w.lvu = lvu; w.lvv = lvv;
    w.qp_map = qp_map; w.sao = sao; w.sao_merge = sao_merge;
    w.sxy16 = scan_blob + scan_offs[(4 - 2) * 6];
    w.cg16 = scan_blob + scan_offs[(4 - 2) * 6 + 1];
    w.sxy8 = scan_blob + scan_offs[(3 - 2) * 6];
    w.cg8 = scan_blob + scan_offs[(3 - 2) * 6 + 1];
    w.sxy32 = scan_blob + scan_offs[(5 - 2) * 6];
    w.cg32 = scan_blob + scan_offs[(5 - 2) * 6 + 1];
    w.roff = roff; w.coff = coff;
    w.mode16 = mode16; w.depth16 = depth16;
    w.qp_prev = state[0];
    w.ir.bins = out_bins; w.ir.ctx = out_ctx; w.ir.n = 0;
    w.cap = cap;
    int mark_cx = w.n_ctu_x - 1 < 1 ? w.n_ctu_x - 1 : 1;
    for (int cy = cy0; cy < cy1; cy++) {
        for (int cx = 0; cx < w.n_ctu_x; cx++) {
            if (w.ir.n > cap - 500000)
                return -1;
            if (w.dqp_enabled) {
                if (w.sync && cx == 0)
                    w.qp_prev = w.slice_qp;
                w.qg_pred = w.qp_prev;
                w.dqp_coded = 0;
                w.cur_qp = qp_map ? qp_map[cy * w.n_ctu_x + cx]
                                  : w.slice_qp;
            }
            if (sao)
                iw_sao(&w, cx, cy);
            iw_qt(&w, cx << w.log2_ctu, cy << w.log2_ctu, w.log2_ctu,
                  0);
            int last = (cy == w.n_ctu_y - 1 && cx == w.n_ctu_x - 1);
            cbin(&w.ir, last, CTX_TERM);
            if (w.dqp_enabled)
                w.qp_prev = w.dqp_coded ? w.cur_qp : w.qg_pred;
            if (w.wpp_terms && cx == mark_cx)
                out_mark[0] = w.ir.n;
            if (w.wpp_terms && cx == w.n_ctu_x - 1 && !last)
                cbin(&w.ir, 1, CTX_TERM);
        }
    }
    state[0] = w.qp_prev;
    return w.ir.n;
}
