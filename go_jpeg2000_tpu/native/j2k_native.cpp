// Native entropy backend: MQ coder + EBCOT Tier-1, batched across
// code-blocks with a thread pool.
//
// Host-side equivalent of the reference's hot native surface (the
// amd64/arm64 assembly kernels, /root/reference/internal/dwt/dwt_amd64.s,
// internal/entropy/t1_amd64.s) and its goroutine block pool
// (encoder.go:690-742): the DWT runs on the device (jnp); the
// irreducibly-sequential-per-block MQ/T1 coding runs here, parallel across
// blocks.  Semantics mirror ops/t1.py (the Python oracle) bit-for-bit and
// are differentially tested against it.
//
// Built on first use by native/loader.py (g++ -O3 -shared -fPIC -std=c++17
// -pthread [-march=native]) into native/_build/.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <thread>
#include <atomic>
#include <algorithm>

namespace {

// ---------------------------------------------------------------- MQ tables
struct QeEntry { uint16_t qe; uint8_t nmps, nlps, sw; };
static const QeEntry QE[47] = {
    {0x5601,1,1,1},{0x3401,2,6,0},{0x1801,3,9,0},{0x0AC1,4,12,0},
    {0x0521,5,29,0},{0x0221,38,33,0},{0x5601,7,6,1},{0x5401,8,14,0},
    {0x4801,9,14,0},{0x3801,10,14,0},{0x3001,11,17,0},{0x2401,12,18,0},
    {0x1C01,13,20,0},{0x1601,29,21,0},{0x5601,15,14,1},{0x5401,16,14,0},
    {0x5101,17,15,0},{0x4801,18,16,0},{0x3801,19,17,0},{0x3401,20,18,0},
    {0x3001,21,19,0},{0x2801,22,19,0},{0x2401,23,20,0},{0x2201,24,21,0},
    {0x1C01,25,22,0},{0x1801,26,23,0},{0x1601,27,24,0},{0x1401,28,25,0},
    {0x1201,29,26,0},{0x1101,30,27,0},{0x0AC1,31,28,0},{0x09C1,32,29,0},
    {0x08A1,33,30,0},{0x0521,34,31,0},{0x0441,35,32,0},{0x02A1,36,33,0},
    {0x0221,37,34,0},{0x0141,38,35,0},{0x0111,39,36,0},{0x0085,40,37,0},
    {0x0049,41,38,0},{0x0025,42,39,0},{0x0015,43,40,0},{0x0009,44,41,0},
    {0x0005,45,42,0},{0x0001,45,43,0},{0x5601,46,46,0},
};

constexpr int NCTX = 19;
constexpr int CTX_RL = 17, CTX_UNI = 18;

// cb_style flags (Table A.19)
constexpr int STY_LAZY = 0x01, STY_RESET = 0x02, STY_TERMALL = 0x04,
              STY_VSC = 0x08, STY_PTERM = 0x10, STY_SEGSYM = 0x20;
// internal (non-spec) flag, above the 8-bit Scb range: skip the exact
// D.4.1 truncation-length computation and record cheap monotone upper
// bounds instead.  Used when pass rates are never consumed (single
// quality layer, no rate budget), where exact lengths only cost time.
constexpr int STY_FAST_RATES = 0x100;
// internal: midpoint-bias reconstruction of truncated lossy blocks — each
// significant sample gains half of its last-updated bitplane (OpenJPEG's
// oneplushalf semantics); full decodes are unaffected (last plane = 0)
constexpr int STY_LOSSY_BIAS = 0x200;

struct CtxState { uint8_t idx, mps; };

static void init_ctx(CtxState* c) {
    for (int i = 0; i < NCTX; i++) c[i] = {0, 0};
    c[CTX_UNI].idx = 46; c[CTX_RL].idx = 3; c[0].idx = 4;
}

// --------------------------------------------------------------- MQ encoder
struct MQEnc {
    CtxState ctx[NCTX];
    uint32_t a, c; int ct;
    std::vector<uint8_t> buf;   // buf[0] = BP-1 sentinel
    void reset_mq() { a = 0x8000; c = 0; ct = 12; buf.assign(1, 0); }
    void reset_ctx() { init_ctx(ctx); }
    void init() { reset_ctx(); reset_mq(); }
    void byteout() {
        if (buf.back() == 0xFF) { stuff(); }
        else if (c < 0x8000000u) { nostuff(); }
        else {
            buf.back() += 1;
            if (buf.back() == 0xFF) { c &= 0x7FFFFFF; stuff(); }
            else nostuff();
        }
    }
    void stuff() { buf.push_back((c >> 20) & 0xFF); c &= 0xFFFFF; ct = 7; }
    void nostuff() { buf.push_back((c >> 19) & 0xFF); c &= 0x7FFFF; ct = 8; }
    void renorm() {
        do {
            a = (a << 1) & 0xFFFF; c = (c << 1);
            if (--ct == 0) byteout();
        } while (!(a & 0x8000));
    }
    void encode(int d, int cx) {
        CtxState& s = ctx[cx];
        const QeEntry& q = QE[s.idx];
        if (d == s.mps) {
            a -= q.qe;
            if (!(a & 0x8000)) {
                if (a < q.qe) a = q.qe; else c += q.qe;
                s.idx = q.nmps; renorm();
            } else c += q.qe;
        } else {
            a -= q.qe;
            if (a < q.qe) c += q.qe; else a = q.qe;
            if (q.sw) s.mps = 1 - s.mps;
            s.idx = q.nlps; renorm();
        }
    }
    // flush current codeword; append to out, return bytes appended
    size_t flush_to(std::vector<uint8_t>& out) {
        uint32_t tempc = c + a - 1;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c <<= ct; byteout();
        c <<= ct; byteout();
        size_t n = buf.size() - 1;
        if (n && buf[n] == 0xFF) n--;   // strip trailing 0xFF (buf[1..n])
        out.insert(out.end(), buf.begin() + 1, buf.begin() + 1 + n);
        return n;
    }
    // predictable termination (C.3.5 / D.4.2): flush the register without
    // SETBITS so a decoder can detect bit errors; no trailing-0xFF strip
    size_t erterm_to(std::vector<uint8_t>& out) {
        int k = 12 - ct;
        while (k > 0) {
            c = (c << ct);
            ct = 0;
            byteout();
            k -= ct;
        }
        if (buf.back() != 0xFF) {
            c = (c << ct);
            byteout();
        }
        size_t n = buf.size() - 1;
        out.insert(out.end(), buf.begin() + 1, buf.end());
        return n;
    }
    size_t pending_bytes() const { return buf.size() - 1 + 2; }
};

// --------------------------------------------------------------- raw coder
struct RawEnc {
    std::vector<uint8_t> buf;
    uint32_t acc = 0; int n = 0;
    int cap() const { return (!buf.empty() && buf.back() == 0xFF) ? 7 : 8; }
    void bit(int b) {
        acc = (acc << 1) | (b & 1);
        if (++n == cap()) { buf.push_back((uint8_t)acc); acc = 0; n = 0; }
    }
    size_t pending_bytes() const { return buf.size() + (n ? 1 : 0); }
    size_t flush_to(std::vector<uint8_t>& out) {
        if (n) { acc <<= (cap() - n); buf.push_back((uint8_t)acc); acc = 0; n = 0; }
        size_t len = buf.size();
        if (len && buf[len - 1] == 0xFF) len--;
        out.insert(out.end(), buf.begin(), buf.begin() + len);
        buf.clear();
        return len;
    }
    // predictable termination: pad the final byte with alternating 0,1,0,1
    size_t erterm_to(std::vector<uint8_t>& out) {
        int bv = 0;
        while (n) { bit(bv); bv = 1 - bv; }
        size_t len = buf.size();
        if (len && buf[len - 1] == 0xFF) len--;
        out.insert(out.end(), buf.begin(), buf.begin() + len);
        buf.clear();
        return len;
    }
};

struct MQDec {
    CtxState ctx[NCTX];
    const uint8_t* data; int len; int bp;
    uint32_t a, c; int ct;
    void init(const uint8_t* d, int l) {
        init_ctx(ctx);
        init_stream(d, l);
    }
    void init_stream(const uint8_t* d, int l) {
        data = d; len = l; bp = 0;
        uint8_t b0 = len > 0 ? data[0] : 0xFF;
        c = (uint32_t)b0 << 16;
        bytein();
        c <<= 7; ct -= 7; a = 0x8000;
    }
    uint8_t at(int i) const { return i < len ? data[i] : 0xFF; }
    void bytein() {
        if (at(bp) == 0xFF) {
            if (at(bp + 1) > 0x8F) { c += 0xFF00; ct = 8; }
            else { bp++; c += (uint32_t)at(bp) << 9; ct = 7; }
        } else { bp++; c += (uint32_t)at(bp) << 8; ct = 8; }
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1; c <<= 1; ct--;
        } while (!(a & 0x8000));
        a &= 0xFFFF;
    }
    int decode(int cx) {
        CtxState& s = ctx[cx];
        const QeEntry& q = QE[s.idx];
        int d;
        a -= q.qe;
        if (((c >> 16) & 0xFFFF) < q.qe) {
            if (a < q.qe) { d = s.mps; s.idx = q.nmps; }
            else {
                d = 1 - s.mps;
                if (q.sw) s.mps = 1 - s.mps;
                s.idx = q.nlps;
            }
            a = q.qe;
            renorm();
        } else {
            c -= (uint32_t)q.qe << 16;
            if (!(a & 0x8000)) {
                if (a < q.qe) {
                    d = 1 - s.mps;
                    if (q.sw) s.mps = 1 - s.mps;
                    s.idx = q.nlps;
                } else { d = s.mps; s.idx = q.nmps; }
                renorm();
            } else d = s.mps;
        }
        return d;
    }
};

struct RawDec {
    const uint8_t* data; int len; int pos = 0;
    uint32_t acc = 0; int n = 0; uint8_t prev = 0;
    int bit() {
        if (n == 0) {
            uint8_t b = pos < len ? data[pos] : 0xFF;
            pos++;
            int cap = (prev == 0xFF) ? 7 : 8;
            acc = b & ((1u << cap) - 1);
            n = cap; prev = b;
        }
        n--;
        return (acc >> n) & 1;
    }
};

// --------------------------------------------------------------- ZC tables
static uint8_t ZC_LUT[3][3][3][5];
static void build_zc() {
    for (int h = 0; h < 3; h++) for (int v = 0; v < 3; v++)
    for (int d = 0; d < 5; d++) {
        int c;
        if (h == 2) c = 8;
        else if (h == 1) c = v >= 1 ? 7 : (d >= 1 ? 6 : 5);
        else if (v == 2) c = 4;
        else if (v == 1) c = 3;
        else if (d >= 2) c = 2;
        else if (d == 1) c = 1;
        else c = 0;
        ZC_LUT[0][h][v][d] = (uint8_t)c;
        ZC_LUT[1][v][h][d] = (uint8_t)c;
        int hv = h + v;
        if (d >= 3) c = 8;
        else if (d == 2) c = hv >= 1 ? 7 : 6;
        else if (d == 1) c = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
        else c = hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
        ZC_LUT[2][h][v][d] = (uint8_t)c;
    }
}
struct ZCInit { ZCInit() { build_zc(); } } zc_init;

// SC table: index (hc+1)*3 + (vc+1) -> {ctx, xor}
static const uint8_t SC_CTX[9] = {13,12,11,10,9,10,11,12,13};
static const uint8_t SC_XOR[9] = {1,1,1,1,0,0,0,0,0};
// order: (h,v) = (-1,-1),(-1,0),(-1,1),(0,-1),(0,0),(0,1),(1,-1),(1,0),(1,1)

// ------------------------------------------------------------ block coder
//
// Packed-flags design (the optimization the reference implements with
// assembly-backed flag arrays, t1_amd64.s): one uint32 per sample caches the
// neighborhood significance/sign so context formation is a single load +
// LUT, with updates only when a sample becomes significant.
//
//  bit 0: SIG   bit 1: VISITED   bit 2: ETA   bit 3: SIGN(negative)
//  bits 4-11: neighbor sigma  W E N S NW NE SW SE
//  bits 12-15: neighbor sign  W E N S
constexpr uint32_t F_SIG = 1, F_VIS = 2, F_ETA = 4, F_SGN = 8;
constexpr uint32_t NB_MASK = 0xFF0;
// VSC: clear S(7+4=bit 7? S is bit 7? -> bits: W=4,E=5,N=6,S=7,NW=8,NE=9,SW=10,SE=11
constexpr uint32_t VSC_MASK = ~((1u << 7) | (1u << 10) | (1u << 11) | (1u << 15));

static uint8_t ZC_FLUT[3][256];
static uint8_t SC_FLUT[256];      // (ctx) | (xor << 5); idx = sig(WENS) | sign(WENS)<<4
static void build_fluts() {
    for (int cls = 0; cls < 3; cls++)
        for (int nb = 0; nb < 256; nb++) {
            int hs = ((nb >> 0) & 1) + ((nb >> 1) & 1);          // W + E
            int vs = ((nb >> 2) & 1) + ((nb >> 3) & 1);          // N + S
            int ds = ((nb >> 4) & 1) + ((nb >> 5) & 1)
                   + ((nb >> 6) & 1) + ((nb >> 7) & 1);          // diagonals
            ZC_FLUT[cls][nb] = ZC_LUT[cls][hs][vs][ds > 4 ? 4 : ds];
        }
    for (int i = 0; i < 256; i++) {
        auto contrib = [&](int sbit, int gbit) -> int {
            if (!((i >> sbit) & 1)) return 0;
            return ((i >> gbit) & 1) ? -1 : 1;
        };
        int hc = contrib(0, 4) + contrib(1, 5);
        hc = hc > 1 ? 1 : (hc < -1 ? -1 : hc);
        int vc = contrib(2, 6) + contrib(3, 7);
        vc = vc > 1 ? 1 : (vc < -1 ? -1 : vc);
        int k = (hc + 1) * 3 + (vc + 1);
        SC_FLUT[i] = SC_CTX[k] | (SC_XOR[k] << 5);
    }
}
struct FlutInit { FlutInit() { build_fluts(); } } flut_init;

struct BlockState {
    int w, h, stride, band_class, style;
    bool vsc;
    std::vector<uint32_t> flags;
    std::vector<uint32_t> v;      // magnitudes (padded)
    BlockState(int w_, int h_, int band, int style_)
        : w(w_), h(h_), stride(w_ + 2), band_class(band), style(style_),
          vsc(style_ & STY_VSC) {
        size_t n = (size_t)(h + 2) * (w + 2);
        flags.assign(n, 0);
        v.assign(n, 0);
    }
    inline int idx(int x, int y) const { return (y + 1) * stride + x + 1; }
    inline uint32_t fl(int pos, int y) const {
        uint32_t f = flags[pos];
        if (vsc && (y & 3) == 3) f &= VSC_MASK;
        return f;
    }
    inline void set_sig(int pos, int s) {
        uint32_t* f = flags.data();
        f[pos - 1]          |= (1u << 5) | ((uint32_t)s << 13);   // E of west nb
        f[pos + 1]          |= (1u << 4) | ((uint32_t)s << 12);   // W of east nb
        f[pos - stride]     |= (1u << 7) | ((uint32_t)s << 15);   // S of north nb
        f[pos + stride]     |= (1u << 6) | ((uint32_t)s << 14);   // N of south nb
        f[pos - stride - 1] |= (1u << 11);                        // SE of NW nb
        f[pos - stride + 1] |= (1u << 10);                        // SW of NE nb
        f[pos + stride - 1] |= (1u << 9);                         // NE of SW nb
        f[pos + stride + 1] |= (1u << 8);                         // NW of SE nb
        f[pos] |= F_SIG | ((uint32_t)s << 3);
    }
    inline int zc(uint32_t f) const {
        return ZC_FLUT[band_class][(f >> 4) & 0xFF];
    }
    inline void sc(uint32_t f, int& cx, int& xr) const {
        uint8_t e = SC_FLUT[((f >> 4) & 0xF) | ((f >> 8) & 0xF0)];
        cx = e & 0x1F; xr = e >> 5;
    }
    inline int mr(uint32_t f) const {
        if (f & F_ETA) return 16;
        return (f & NB_MASK) ? 15 : 14;
    }
};

static inline bool pass_is_raw(int pass_idx, bool lazy) {
    if (!lazy || pass_idx < 10) return false;
    int ph = (pass_idx - 1) % 3;
    return ph == 0 || ph == 1;
}

// --------------------------------------------------------- exact pass rates
// Sufficient (D.4.1 semantics) truncation lengths, mirroring the Python
// oracle (ops/mq.py exact_rates) bit-for-bit.  Always valid; minimal except
// one rare aligned-boundary corner (see the Python docstring, ADVICE r3).  A truncated segment
// decodes the passes up to a boundary iff the decoder's perceived value —
// the prefix followed by all 1-bits (BYTEIN feeds 0xFF past the end) —
// lies inside the boundary's code interval [L, L+A).  The encoder's
// (buf, C, CT) triple is a lazy big-int representation of L; A its width.
// Both bounds must be checked: a byte following 0xFF may carry (value up
// to 0x8F > the 7 one-bits padding assumes), so the padded value can fall
// below L as well as reach L+A.

struct MQMark { int pass_index; std::vector<uint8_t> buf; uint32_t c; int ct; uint32_t a; };
struct RawMark { int pass_index; size_t pending; };

// add v into the bit vector with LSB at position `pos`, rippling carries up
static inline void bits_add(std::vector<uint8_t>& bits, long pos, uint64_t v) {
    int carry = 0;
    while ((v || carry) && pos >= 0) {
        int sum = bits[(size_t)pos] + (int)(v & 1) + carry;
        bits[(size_t)pos] = (uint8_t)(sum & 1);
        carry = sum >> 1;
        v >>= 1;
        pos--;
    }
}

// append one stuffing-coded byte to an expanded bit string (8 positions, or
// 7 after an 0xFF byte; a carry byte ripples into earlier bits)
static inline void bits_push_byte(std::vector<uint8_t>& bits, bool& prev_ff,
                                  uint8_t b) {
    int wdt = prev_ff ? 7 : 8;
    bits.resize(bits.size() + (size_t)wdt, 0);
    bits_add(bits, (long)bits.size() - 1, b);
    prev_ff = (b == 0xFF);
}

static std::vector<uint8_t> expand_bits(const uint8_t* buf, size_t n,
                                        uint64_t extra, int extra_bits) {
    std::vector<uint8_t> bits;
    bits.reserve(n * 8 + (size_t)extra_bits + 8);
    bool prev_ff = false;
    for (size_t i = 0; i < n; i++) bits_push_byte(bits, prev_ff, buf[i]);
    if (extra_bits > 0) {
        bits.resize(bits.size() + (size_t)extra_bits, 0);
        bits_add(bits, (long)bits.size() - 1, extra);
    }
    return bits;
}

// (prefix bits ++ all-ones) in [low, top)?  All three are MSB-aligned at
// the sentinel byte; beyond its length the prefix continues with 1s and
// low/top with 0s.
static bool trunc_ok(const std::vector<uint8_t>& pref,
                     const std::vector<uint8_t>& low,
                     const std::vector<uint8_t>& top) {
    size_t n = pref.size() > top.size() ? pref.size() : top.size();
    bool lt = false;
    for (size_t i = 0; i < n; i++) {
        int p = i < pref.size() ? pref[i] : 1;
        int t = i < top.size() ? top[i] : 0;
        if (p != t) { lt = p < t; break; }
    }
    if (!lt) return false;
    size_t m = pref.size() > low.size() ? pref.size() : low.size();
    for (size_t i = 0; i < m; i++) {
        int p = i < pref.size() ? pref[i] : 1;
        int l = i < low.size() ? low[i] : 0;
        if (p != l) return p > l;
    }
    return true;
}

struct PassRec { int rate; double dist; uint8_t term; uint8_t type; };

struct EncodeOut {
    std::vector<uint8_t> data;
    std::vector<PassRec> passes;
    std::vector<int> seg_lens;
    int numbps = 0;
};

static void t1_encode_one(const int32_t* coeffs, int w, int h, int band,
                          int style, EncodeOut& out) {
    int64_t maxmag = 0;
    for (int i = 0; i < w * h; i++) {
        int64_t m = std::abs((int64_t)coeffs[i]);
        if (m > maxmag) maxmag = m;
    }
    int numbps = 0;
    while (maxmag >> numbps) numbps++;
    out.numbps = numbps;
    if (numbps == 0) return;

    BlockState st(w, h, band, style);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            int32_t cval = coeffs[y * w + x];
            int p = st.idx(x, y);
            st.v[p] = (uint32_t)std::abs((int64_t)cval);
            if (cval < 0) st.flags[p] |= F_SGN;   // input sign (pre-sig)
        }

    const bool lazy = style & STY_LAZY, reset = style & STY_RESET,
               termall = style & STY_TERMALL, segsym = style & STY_SEGSYM;
    MQEnc mq; mq.init();
    RawEnc raw;
    bool mode_raw = false;
    std::vector<uint8_t>& outbuf = out.data;
    std::vector<double> rec((size_t)(h + 2) * (w + 2), 0.0);
    double dist_total = 0.0;
    int pass_idx = 0;

    auto dist_delta = [&](int pos, int plane, bool refine) -> double {
        double truev = (double)st.v[pos];
        double oldr = rec[pos];
        double newr;
        if (refine) {
            int64_t base = ((int64_t)st.v[pos] >> plane) << plane;
            newr = (double)base + (plane > 0 ? (double)(1ll << (plane - 1)) : 0.0);
        } else {
            newr = (double)(1ll << plane)
                 + (plane > 0 ? (double)(1ll << (plane - 1)) : 0.0);
        }
        rec[pos] = newr;
        double eo = (truev - oldr) * (truev - oldr);
        double en = (truev - newr) * (truev - newr);
        return eo - en;
    };

    bool pterm = (style & STY_PTERM) != 0;
    const bool fast_rates = (style & STY_FAST_RATES) != 0;
    std::vector<MQMark> mq_marks;
    std::vector<RawMark> raw_marks;
    auto terminate = [&]() {
        size_t base = outbuf.size();
        size_t n;
        if (mode_raw) {
            n = pterm ? raw.erterm_to(outbuf) : raw.flush_to(outbuf);
            for (const RawMark& rm : raw_marks)
                out.passes[(size_t)rm.pass_index].rate =
                    (int)(base + (rm.pending < n ? rm.pending : n));
        } else {
            n = pterm ? mq.erterm_to(outbuf) : mq.flush_to(outbuf);
            // exact minimal truncation lengths for the marked boundaries
            std::vector<uint8_t> pref;   // expanded prefix bits, incremental
            bool pref_ff = false;
            size_t folded = 0;
            size_t prev_n = 0;
            bits_push_byte(pref, pref_ff, mq.buf[0]);   // sentinel
            folded = 1;
            for (const MQMark& mk : mq_marks) {
                uint64_t pend_top = (uint64_t)mk.c + mk.a;
                int pend_bits = 27 - mk.ct;
                std::vector<uint8_t> top = expand_bits(
                    mk.buf.data(), mk.buf.size(), pend_top, pend_bits);
                std::vector<uint8_t> low = expand_bits(
                    mk.buf.data(), mk.buf.size(), mk.c, pend_bits);
                // sound lower bound (mirrors ops/mq.py exact_rates): the
                // interval width a >= 2^15 at scale 2^-top.size(), so a
                // prefix leaving >16 low bits free can't pin the padded
                // value; scan starts O(1) bytes from the answer.
                long lo = ((long)top.size() - 32) / 8 - 1;
                size_t cand = prev_n;
                if (lo > (long)cand) cand = (size_t)lo;
                for (;;) {
                    while (folded < 1 + cand) {
                        bits_push_byte(pref, pref_ff, mq.buf[folded]);
                        folded++;
                    }
                    if (cand >= n) break;
                    if (trunc_ok(pref, low, top)) break;
                    cand++;
                }
                out.passes[(size_t)mk.pass_index].rate = (int)(base + cand);
                prev_n = cand;
            }
            mq.reset_mq();
        }
        mq_marks.clear();
        raw_marks.clear();
        out.seg_lens.push_back((int)n);
    };
    auto mark_pass = [&](int idx) {
        if (fast_rates) {
            // cheap monotone upper bound; clamped after termination
            out.passes[(size_t)idx].rate = (int)(outbuf.size() +
                (mode_raw ? raw.pending_bytes() : mq.pending_bytes()));
            return;
        }
        if (mode_raw) raw_marks.push_back(RawMark{idx, raw.pending_bytes()});
        else mq_marks.push_back(MQMark{idx, mq.buf, mq.c, mq.ct, mq.a});
    };
    auto end_pass = [&](int ptype, int plane) {
        bool term = false;
        if (termall) term = true;
        else if (lazy) {
            int nxt = pass_idx + 1;
            if (nxt >= 10 && pass_is_raw(pass_idx, true) != pass_is_raw(nxt, true))
                term = true;
        }
        PassRec pr{0, dist_total, (uint8_t)term, (uint8_t)ptype};
        out.passes.push_back(pr);
        if (term) { terminate(); out.passes.back().rate = (int)outbuf.size(); }
        else mark_pass((int)out.passes.size() - 1);
        if (reset) mq.reset_ctx();
        pass_idx++;
    };

    uint32_t* F = st.flags.data();
    for (int plane = numbps - 1; plane >= 0; plane--) {
        uint32_t mask = 1u << plane;
        bool first = plane == numbps - 1;

        if (!first) {
            bool use_raw = lazy && pass_idx >= 10;
            if (use_raw && !mode_raw) { raw = RawEnc(); }
            mode_raw = use_raw;
            for (int y0 = 0; y0 < h; y0 += 4) {
                int ylim = std::min(y0 + 4, h);
                for (int x = 0; x < w; x++) {
                    // column skip: SPP codes only insignificant samples
                    // with a significant neighbor — one OR over the
                    // stripe column rejects the (common) empty case
                    if (ylim == y0 + 4) {
                        int p0 = st.idx(x, y0);
                        uint32_t any = F[p0] | F[p0 + st.stride]
                            | F[p0 + 2 * st.stride] | F[p0 + 3 * st.stride];
                        if (!(any & (F_SIG | NB_MASK))) continue;
                    }
                    for (int y = y0; y < ylim; y++) {
                        int pos = st.idx(x, y);
                        uint32_t f = F[pos];
                        if (f & F_SIG) continue;
                        uint32_t fm = st.fl(pos, y);
                        if (!(fm & NB_MASK)) continue;
                        int bit = (st.v[pos] & mask) ? 1 : 0;
                        if (use_raw) raw.bit(bit);
                        else mq.encode(bit, st.zc(fm));
                        if (bit) {
                            int s = (f >> 3) & 1;
                            if (use_raw) raw.bit(s);
                            else {
                                int cx, xr; st.sc(fm, cx, xr);
                                mq.encode(s ^ xr, cx);
                            }
                            st.set_sig(pos, s);
                            dist_total += dist_delta(pos, plane, false);
                        }
                        F[pos] |= F_VIS;
                    }
                }
            }
            end_pass(0, plane);

            use_raw = lazy && pass_idx >= 10;
            if (use_raw && !mode_raw) { raw = RawEnc(); }
            mode_raw = use_raw;
            for (int y0 = 0; y0 < h; y0 += 4) {
                int ylim = std::min(y0 + 4, h);
                for (int x = 0; x < w; x++) {
                    if (ylim == y0 + 4) {
                        int p0 = st.idx(x, y0);
                        uint32_t any = F[p0] | F[p0 + st.stride]
                            | F[p0 + 2 * st.stride] | F[p0 + 3 * st.stride];
                        if (!(any & F_SIG)) continue;     // nothing to refine
                    }
                    for (int y = y0; y < ylim; y++) {
                        int pos = st.idx(x, y);
                        uint32_t f = F[pos];
                        if (!(f & F_SIG) || (f & F_VIS)) continue;
                        int bit = (st.v[pos] & mask) ? 1 : 0;
                        if (use_raw) raw.bit(bit);
                        else mq.encode(bit, st.mr(st.fl(pos, y)));
                        F[pos] |= F_ETA;
                        dist_total += dist_delta(pos, plane, true);
                    }
                }
            }
            end_pass(1, plane);
        }

        // cleanup
        mode_raw = false;
        for (int y0 = 0; y0 < h; y0 += 4) {
            int stripe_h = std::min(4, h - y0);
            for (int x = 0; x < w; x++) {
                int y = y0;
                bool use_rl = false;
                if (stripe_h == 4) {
                    use_rl = true;
                    for (int yy = y0; yy < y0 + 4; yy++) {
                        uint32_t f = st.fl(st.idx(x, yy), yy);
                        if (f & (F_SIG | F_VIS | NB_MASK)) { use_rl = false; break; }
                    }
                }
                if (use_rl) {
                    int first_sig = -1;
                    for (int r = 0; r < 4; r++)
                        if (st.v[st.idx(x, y0 + r)] & mask) { first_sig = r; break; }
                    if (first_sig < 0) {
                        mq.encode(0, CTX_RL);
                        for (int yy = y0; yy < y0 + 4; yy++)
                            F[st.idx(x, yy)] &= ~F_VIS;
                        continue;
                    }
                    mq.encode(1, CTX_RL);
                    mq.encode((first_sig >> 1) & 1, CTX_UNI);
                    mq.encode(first_sig & 1, CTX_UNI);
                    int yy = y0 + first_sig;
                    int pos = st.idx(x, yy);
                    uint32_t fm = st.fl(pos, yy);
                    int cx, xr; st.sc(fm, cx, xr);
                    int s = (F[pos] >> 3) & 1;
                    mq.encode(s ^ xr, cx);
                    st.set_sig(pos, s);
                    dist_total += dist_delta(pos, plane, false);
                    y = yy + 1;
                }
                for (int yy = y; yy < y0 + stripe_h; yy++) {
                    int pos = st.idx(x, yy);
                    uint32_t f = F[pos];
                    if (f & F_VIS) { F[pos] &= ~F_VIS; continue; }
                    if (f & F_SIG) continue;
                    uint32_t fm = st.fl(pos, yy);
                    int bit = (st.v[pos] & mask) ? 1 : 0;
                    mq.encode(bit, st.zc(fm));
                    if (bit) {
                        int cx, xr; st.sc(fm, cx, xr);
                        int s = (f >> 3) & 1;
                        mq.encode(s ^ xr, cx);
                        st.set_sig(pos, s);
                        dist_total += dist_delta(pos, plane, false);
                    }
                }
                for (int yy = y0; yy < y; yy++) F[st.idx(x, yy)] &= ~F_VIS;
            }
        }
        if (segsym) {
            mq.encode(1, CTX_UNI); mq.encode(0, CTX_UNI);
            mq.encode(1, CTX_UNI); mq.encode(0, CTX_UNI);
        }
        end_pass(2, plane);
    }

    if (!out.passes.empty() && !out.passes.back().term) {
        out.passes.back().term = 1;
        // the final pass's mark is superseded by its termination
        if (mode_raw && !raw_marks.empty()) raw_marks.pop_back();
        else if (!mode_raw && !mq_marks.empty()) mq_marks.pop_back();
        terminate();
        out.passes.back().rate = (int)outbuf.size();
    }
    if (fast_rates)
        for (int i = (int)out.passes.size() - 2; i >= 0; i--)
            if (out.passes[i].rate > out.passes[i + 1].rate)
                out.passes[i].rate = out.passes[i + 1].rate;
}

// ------------------------------------------------------------ decode
static void t1_decode_one(const uint8_t* data, int data_len, int w, int h,
                          int numbps, int num_passes, int band, int style,
                          const int32_t* seg_lens, int num_segs,
                          int32_t* out) {
    std::memset(out, 0, sizeof(int32_t) * (size_t)w * h);
    if (numbps == 0 || num_passes == 0) return;
    BlockState st(w, h, band, style);
    const bool lazy = style & STY_LAZY, reset = style & STY_RESET,
               segsym = style & STY_SEGSYM;
    const bool lossy_bias = style & STY_LOSSY_BIAS;
    std::vector<uint8_t> lp; // last-updated plane per sample (lossy bias)
    if (lossy_bias) lp.assign((size_t)(h + 2) * (w + 2), 0);
    uint8_t* LP = lossy_bias ? lp.data() : nullptr;
    const bool termall = style & STY_TERMALL;

    std::vector<int> seg_passes;
    if (num_passes > 0) {
        if (termall) seg_passes.assign(num_passes, 1);
        else if (lazy) {
            int p = 0;
            int firstn = std::min(10, num_passes);
            seg_passes.push_back(firstn); p = firstn;
            while (p < num_passes) {
                int n = std::min(2, num_passes - p);
                seg_passes.push_back(n); p += n;
                if (p < num_passes) { seg_passes.push_back(1); p += 1; }
            }
        } else seg_passes.assign(1, num_passes);
    }
    std::vector<std::pair<int,int>> seg_ranges;
    {
        int off = 0;
        int n = num_segs > 0 ? num_segs : 1;
        if (num_segs <= 0 || num_segs != (int)seg_passes.size()) {
            seg_passes.assign(1, num_passes);
            seg_ranges.push_back({0, data_len});
        } else {
            for (int i = 0; i < n; i++) {
                seg_ranges.push_back({off, off + seg_lens[i]});
                off += seg_lens[i];
            }
        }
    }

    MQDec mq; bool mq_inited = false;
    RawDec rd;
    int seg_i = -1, left_in_seg = 0;
    bool cur_raw = false;
    int pass_idx = 0;

    auto open_segment = [&]() {
        seg_i++;
        int s = 0, e = 0;
        if (seg_i < (int)seg_ranges.size()) { s = seg_ranges[seg_i].first; e = seg_ranges[seg_i].second; }
        if (e > data_len) e = data_len;
        if (s > e) s = e;
        cur_raw = pass_is_raw(pass_idx, lazy);
        if (cur_raw) { rd = RawDec{data + s, e - s}; }
        else {
            CtxState backup[NCTX];
            if (mq_inited) std::memcpy(backup, mq.ctx, sizeof(backup));
            mq.init(data + s, e - s);
            if (mq_inited) std::memcpy(mq.ctx, backup, sizeof(backup));
            mq_inited = true;
        }
        left_in_seg = seg_i < (int)seg_passes.size() ? seg_passes[seg_i] : 1;
    };
    auto begin_pass = [&]() { if (left_in_seg == 0) open_segment(); };
    auto finish_pass = [&]() {
        left_in_seg--;
        if (reset && mq_inited) init_ctx(mq.ctx);
        pass_idx++;
    };

    uint32_t* F = st.flags.data();
    int total = 0;
    for (int plane = numbps - 1; plane >= 0; plane--) {
        bool first = plane == numbps - 1;
        uint32_t bitval = 1u << plane;
        if (!first) {
            if (total >= num_passes) break;
            begin_pass();
            bool use_raw = cur_raw;
            for (int y0 = 0; y0 < h; y0 += 4) {
                int ylim = std::min(y0 + 4, h);
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < ylim; y++) {
                        int pos = st.idx(x, y);
                        uint32_t f = F[pos];
                        if (f & F_SIG) continue;
                        uint32_t fm = st.fl(pos, y);
                        if (!(fm & NB_MASK)) continue;
                        int bit = use_raw ? rd.bit() : mq.decode(st.zc(fm));
                        if (bit) {
                            int s;
                            if (use_raw) s = rd.bit();
                            else {
                                int cx, xr; st.sc(fm, cx, xr);
                                s = mq.decode(cx) ^ xr;
                            }
                            st.set_sig(pos, s);
                            st.v[pos] |= bitval;
                            if (LP) LP[pos] = (uint8_t)plane;
                        }
                        F[pos] |= F_VIS;
                    }
            }
            finish_pass(); total++;

            if (total >= num_passes) break;
            begin_pass();
            use_raw = cur_raw;
            for (int y0 = 0; y0 < h; y0 += 4) {
                int ylim = std::min(y0 + 4, h);
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < ylim; y++) {
                        int pos = st.idx(x, y);
                        uint32_t f = F[pos];
                        if (!(f & F_SIG) || (f & F_VIS)) continue;
                        int bit = use_raw ? rd.bit() : mq.decode(st.mr(st.fl(pos, y)));
                        F[pos] |= F_ETA;
                        if (bit) st.v[pos] |= bitval;
                        if (LP) LP[pos] = (uint8_t)plane;
                    }
            }
            finish_pass(); total++;
        }

        if (total >= num_passes) break;
        begin_pass();
        for (int y0 = 0; y0 < h; y0 += 4) {
            int stripe_h = std::min(4, h - y0);
            for (int x = 0; x < w; x++) {
                int y = y0;
                bool use_rl = false;
                if (stripe_h == 4) {
                    use_rl = true;
                    for (int yy = y0; yy < y0 + 4; yy++) {
                        uint32_t f = st.fl(st.idx(x, yy), yy);
                        if (f & (F_SIG | F_VIS | NB_MASK)) { use_rl = false; break; }
                    }
                }
                if (use_rl) {
                    if (mq.decode(CTX_RL) == 0) {
                        for (int yy = y0; yy < y0 + 4; yy++)
                            F[st.idx(x, yy)] &= ~F_VIS;
                        continue;
                    }
                    int r = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI);
                    int yy = y0 + r;
                    int pos = st.idx(x, yy);
                    uint32_t fm = st.fl(pos, yy);
                    int cx, xr; st.sc(fm, cx, xr);
                    int s = mq.decode(cx) ^ xr;
                    st.set_sig(pos, s);
                    st.v[pos] |= bitval;
                    if (LP) LP[pos] = (uint8_t)plane;
                    y = yy + 1;
                }
                for (int yy = y; yy < y0 + stripe_h; yy++) {
                    int pos = st.idx(x, yy);
                    uint32_t f = F[pos];
                    if (f & F_VIS) { F[pos] &= ~F_VIS; continue; }
                    if (f & F_SIG) continue;
                    uint32_t fm = st.fl(pos, yy);
                    int bit = mq.decode(st.zc(fm));
                    if (bit) {
                        int cx, xr; st.sc(fm, cx, xr);
                        int s = mq.decode(cx) ^ xr;
                        st.set_sig(pos, s);
                        st.v[pos] |= bitval;
                        if (LP) LP[pos] = (uint8_t)plane;
                    }
                }
                for (int yy = y0; yy < y; yy++) F[st.idx(x, yy)] &= ~F_VIS;
            }
        }
        if (segsym) { mq.decode(CTX_UNI); mq.decode(CTX_UNI); mq.decode(CTX_UNI); mq.decode(CTX_UNI); }
        finish_pass(); total++;
    }

    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            int pos = st.idx(x, y);
            int64_t m = st.v[pos];
            // lossy bias: output scaled x2 with the midpoint of the
            // sample's last-updated plane (OpenJPEG's oneplushalf in its
            // x2 fixed-point convention; the dequantizer multiplies by
            // stepsize/2).  Insignificant samples stay 0.
            if (LP && (F[pos] & F_SIG))
                m = (m << 1) + (1ll << LP[pos]);
            out[y * w + x] = (int32_t)((F[pos] & F_SGN) && (F[pos] & F_SIG) ? -m : m);
        }
}

// ----------------------------------------------------------- batch harness
template <typename F>
static void parallel_for(int n, int n_threads, F&& fn) {
    if (n_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; i++) fn(i);
        return;
    }
    std::atomic<int> next{0};
    int nt = std::min(n_threads, n);
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; t++)
        threads.emplace_back([&]() {
            for (;;) {
                int i = next.fetch_add(1);
                if (i >= n) break;
                fn(i);
            }
        });
    for (auto& th : threads) th.join();
}

} // namespace

extern "C" {

constexpr int MAX_PASSES = 160;
constexpr int MAX_SEGS = 160;

// Encode a batch.  Caller provides per-block output capacity regions.
// Returns 0 on success, -k if block k-1's output region overflowed.
int t1_encode_batch(
    const int32_t* coeffs, const int64_t* coeff_offsets,
    const int32_t* ws, const int32_t* hs,
    const int32_t* bands, const int32_t* styles,
    int32_t n_blocks,
    uint8_t* out_data, const int64_t* out_offsets,
    int32_t* numbps_out, int32_t* npasses_out, int32_t* datalen_out,
    int32_t* nsegs_out,
    int32_t* pass_rates, double* pass_dist, uint8_t* pass_term,
    uint8_t* pass_types, int32_t* seg_lens,
    int32_t n_threads)
{
    std::atomic<int> err{0};
    parallel_for(n_blocks, n_threads, [&](int i) {
        EncodeOut eo;
        t1_encode_one(coeffs + coeff_offsets[i], ws[i], hs[i], bands[i],
                      styles[i], eo);
        int64_t cap = out_offsets[i + 1] - out_offsets[i];
        if ((int64_t)eo.data.size() > cap ||
            (int)eo.passes.size() > MAX_PASSES ||
            (int)eo.seg_lens.size() > MAX_SEGS) {
            err.store(-(i + 1));
            return;
        }
        std::memcpy(out_data + out_offsets[i], eo.data.data(), eo.data.size());
        numbps_out[i] = eo.numbps;
        npasses_out[i] = (int)eo.passes.size();
        datalen_out[i] = (int)eo.data.size();
        nsegs_out[i] = (int)eo.seg_lens.size();
        for (size_t p = 0; p < eo.passes.size(); p++) {
            pass_rates[(size_t)i * MAX_PASSES + p] = eo.passes[p].rate;
            pass_dist[(size_t)i * MAX_PASSES + p] = eo.passes[p].dist;
            pass_term[(size_t)i * MAX_PASSES + p] = eo.passes[p].term;
            pass_types[(size_t)i * MAX_PASSES + p] = eo.passes[p].type;
        }
        for (size_t s2 = 0; s2 < eo.seg_lens.size(); s2++)
            seg_lens[(size_t)i * MAX_SEGS + s2] = eo.seg_lens[s2];
    });
    return err.load();
}

int t1_decode_batch(
    const uint8_t* data, const int64_t* data_offsets, const int32_t* data_lens,
    const int32_t* ws, const int32_t* hs,
    const int32_t* numbps, const int32_t* numpasses,
    const int32_t* bands, const int32_t* styles,
    const int32_t* seg_lens, const int32_t* seg_counts,
    int32_t n_blocks,
    int32_t* out, const int64_t* out_offsets,
    int32_t n_threads)
{
    parallel_for(n_blocks, n_threads, [&](int i) {
        t1_decode_one(data + data_offsets[i], data_lens[i], ws[i], hs[i],
                      numbps[i], numpasses[i], bands[i], styles[i],
                      seg_lens + (size_t)i * MAX_SEGS, seg_counts[i],
                      out + out_offsets[i]);
    });
    return 0;
}

int j2k_native_abi_version() { return 1; }

} // extern "C"

// ===========================================================================
// HTJ2K (ISO/IEC 15444-15) cleanup-pass block coder — native port of
// ops/ht.py (bit-identical; differentially tested).  OpenJPEG-conformant.
// ===========================================================================
namespace ht {

#include "ht_tables.inc"

static const int HT_MEL_E[13] = {0,0,0,1,1,1,2,2,2,3,3,4,5};

// encoder candidate lists: (ctx, rho, uoff) -> entries
struct EncEntry { uint8_t e1, ek, ln; uint8_t cwd; };
static std::vector<EncEntry> enc_lists[2][8][16][2];
static bool enc_built = false;
static void build_enc() {
    if (enc_built) return;
    for (int t = 0; t < 2; t++) {
        const uint32_t* keys = t ? HT_ENC1_KEYS : HT_ENC0_KEYS;
        const uint16_t* vals = t ? HT_ENC1_VALS : HT_ENC0_VALS;
        int n = t ? HT_ENC1_N : HT_ENC0_N;
        for (int i = 0; i < n; i++) {
            uint32_t k = keys[i];
            int ctx = (k >> 13) & 7, rho = (k >> 9) & 0xF, uoff = (k >> 8) & 1;
            int e1 = (k >> 4) & 0xF, ek = k & 0xF;
            int cwd = vals[i] & 0xFF, ln = (vals[i] >> 8) & 0xF;
            enc_lists[t][ctx][rho][uoff].push_back(
                {(uint8_t)e1, (uint8_t)ek, (uint8_t)ln, (uint8_t)cwd});
        }
    }
    enc_built = true;
}
struct HtInit { HtInit() { build_enc(); } } ht_init;

static inline int exponent(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

// ---- writers ----
struct MagW {
    std::vector<uint8_t> buf; uint64_t acc = 0; int n = 0; bool last_ff = false;
    void put(uint32_t v, int nb) {
        acc |= (uint64_t)(v & ((nb < 32 ? (1u << nb) : 0u) - 1u)) << n;
        if (nb >= 32) acc |= (uint64_t)v << n;
        n += nb;
        while (n >= (last_ff ? 7 : 8)) {
            int cap = last_ff ? 7 : 8;
            uint8_t b = acc & ((1u << cap) - 1);
            acc >>= cap; n -= cap;
            buf.push_back(b); last_ff = (b == 0xFF);
        }
    }
    void flush() {
        if (n > 0) {
            int cap = last_ff ? 7 : 8;
            buf.push_back(acc & ((1u << cap) - 1));
            acc = 0; n = 0;
        }
    }
};

struct MelW {
    int k = 0, run = 0;
    std::vector<uint8_t> bits;
    void event(int e) {
        int thresh = 1 << HT_MEL_E[k];
        if (!e) {
            if (++run == thresh) { bits.push_back(1); run = 0; k = std::min(12, k + 1); }
        } else {
            bits.push_back(0);
            for (int i = HT_MEL_E[k] - 1; i >= 0; i--) bits.push_back((run >> i) & 1);
            run = 0; k = std::max(0, k - 1);
        }
    }
    void terminate() { if (run > 0) { bits.push_back(1); run = 0; } }
    std::vector<uint8_t> bytes() const {
        std::vector<uint8_t> out; uint32_t acc = 0; int n = 0; bool lf = false;
        for (uint8_t b : bits) {
            int cap = lf ? 7 : 8;
            acc = (acc << 1) | b;
            if (++n == cap) { out.push_back((uint8_t)acc); lf = (acc == 0xFF); acc = 0; n = 0; }
        }
        if (n) {
            int cap = lf ? 7 : 8;
            out.push_back((uint8_t)(acc << (cap - n)));
        }
        if (out.empty()) out.push_back(0);
        if (out.back() == 0xFF) out.push_back(0);
        return out;
    }
};

struct VlcW {
    std::vector<uint8_t> bits;
    void put(uint32_t v, int nb) {
        for (int i = 0; i < nb; i++) bits.push_back((v >> i) & 1);
    }
};

// ---- readers (mirror ops/ht.py) ----
struct MelR {
    const uint8_t* data; int len, pos, size, k = 0;
    uint64_t tmp = 0; int bits = 0; bool unstuff = false;
    std::vector<int> runs;
    MelR(const uint8_t* d, int l, int start, int sz)
        : data(d), len(l), pos(start), size(sz) {
        int num = std::min(4, 4 - (pos & 3));
        for (int i = 0; i < num && size > 0; i++) {
            uint8_t b = pos < len ? data[pos] : 0xFF;
            pos++; size--;
            if (size == 1) b |= 0x0F;
            int db = unstuff ? 7 : 8;
            tmp = (tmp << db) | b;
            bits += db;
            unstuff = (b == 0xFF);
        }
        tmp <<= (64 - bits);
    }
    void read() {
        if (bits > 32) return;
        for (int i = 0; i < 4; i++) {
            uint8_t b;
            if (size <= 0) b = 0xFF;
            else {
                b = pos < len ? data[pos] : 0xFF;
                pos++; size--;
                if (size == 1) b |= 0x0F;
            }
            int db = unstuff ? 7 : 8;
            tmp |= (uint64_t)b << (56 - bits + (8 - db));
            bits += db;
            unstuff = (b == 0xFF);
        }
    }
    void decode_runs() {
        if (bits < 6) read();
        while (bits >= 6 && runs.size() < 8) {
            int ev = HT_MEL_E[k];
            if (tmp & (1ull << 63)) {
                runs.push_back(((1 << ev) - 1) << 1);
                k = std::min(12, k + 1);
                tmp <<= 1; bits -= 1;
            } else {
                int run = (int)((tmp >> (63 - ev)) & ((1ull << ev) - 1));
                k = std::max(0, k - 1);
                tmp <<= (ev + 1); bits -= ev + 1;
                runs.push_back((run << 1) + 1);
            }
        }
    }
    int get_run() {
        if (runs.empty()) decode_runs();
        int r = runs.front();
        runs.erase(runs.begin());
        return r;
    }
};

struct RevR {
    const uint8_t* data; int len, pos, size;
    uint64_t tmp = 0; int bits = 0; bool unstuff = false;
    RevR(const uint8_t* d, int l, int p, int sz) : data(d), len(l), pos(p), size(sz) {
        uint8_t b = (pos >= 0 && pos < len) ? data[pos] : 0;
        pos--;
        tmp = b >> 4;
        bits = ((tmp & 7) == 7) ? 3 : 4;
        unstuff = (b | 0x0F) > 0x8F;
        int num = std::min(1 + (pos & 3), std::max(0, size));
        for (int i = 0; i < num; i++) {
            uint8_t bb = (pos >= 0 && pos < len) ? data[pos] : 0;
            pos--;
            int db = (unstuff && (bb & 0x7F) == 0x7F) ? 7 : 8;
            tmp |= (uint64_t)bb << bits;
            bits += db;
            unstuff = bb > 0x8F;
        }
        size -= num;
        read();
    }
    void read() {
        if (bits > 32) return;
        int take = std::min(4, std::max(0, size));
        uint8_t got[4] = {0, 0, 0, 0};
        for (int i = 0; i < take; i++) {
            int p = pos - i;
            got[i] = (p >= 0 && p < len) ? data[p] : 0;
        }
        pos -= take; size -= take;
        for (int i = 0; i < 4; i++) {
            uint8_t b = got[i];
            int db = (unstuff && (b & 0x7F) == 0x7F) ? 7 : 8;
            tmp |= (uint64_t)b << bits;
            bits += db;
            unstuff = b > 0x8F;
        }
    }
    uint32_t fetch() {
        if (bits < 32) { read(); if (bits < 32) read(); }
        return (uint32_t)tmp;
    }
    void advance(int n) { tmp >>= n; bits -= n; }
};

struct FwdR {
    const uint8_t* data; int len, pos, size; uint8_t fill;
    uint64_t tmp = 0; int bits = 0; bool unstuff = false;
    FwdR(const uint8_t* d, int l, int start, int sz, uint8_t f = 0xFF)
        : data(d), len(l), pos(start), size(sz), fill(f) {
        int num = 4 - (pos & 3);
        for (int i = 0; i < num; i++) step();
    }
    void step() {
        uint8_t b;
        if (size > 0 && pos < len) { b = data[pos]; pos++; size--; }
        else if (size > 0) { b = fill; size--; }
        else b = fill;
        int db = unstuff ? 7 : 8;
        tmp |= (uint64_t)b << bits;
        bits += db;
        unstuff = (b == 0xFF);
    }
    void read() { if (bits > 32) return; for (int i = 0; i < 4; i++) step(); }
    uint32_t fetch() {
        if (bits < 32) { read(); if (bits < 32) read(); }
        return (uint32_t)tmp;
    }
    void advance(int n) { tmp >>= n; bits -= n; }
};

// UVLC value coding: biased value t >= 1
static inline void uvlc_enc(int t, int& pfx, int& pl, int& sfx, int& sl) {
    if (t == 1) { pfx = 1; pl = 1; sfx = 0; sl = 0; }
    else if (t == 2) { pfx = 2; pl = 2; sfx = 0; sl = 0; }
    else if (t <= 4) { pfx = 4; pl = 3; sfx = t - 3; sl = 1; }
    else { pfx = 0; pl = 3; sfx = t - 5; sl = 5; }
}
static inline void uvlc_dec_prefix(uint32_t w, int& pl, int& sl, int& base) {
    if (w & 1) { pl = 1; sl = 0; base = 1; }
    else if ((w & 3) == 2) { pl = 2; sl = 0; base = 2; }
    else if ((w & 7) == 4) { pl = 3; sl = 1; base = 3; }
    else { pl = 3; sl = 5; base = 5; }
}

static inline int ctx_initial_next(int rho) { return ((rho & 1) | (rho >> 1)) & 7; }
static inline int ls_at(const uint8_t* sig, int n, int i) {
    return (i >= 0 && i < n) ? sig[i] : 0;
}
static inline int ctx_noninit(int qx, const uint8_t* psig, int n, int w_rho) {
    int w = (w_rho & 0xC) ? 1 : 0;
    int nn = ls_at(psig, n, qx) ? 1 : 0;
    int ne = ls_at(psig, n, qx + 1) ? 1 : 0;
    return nn | (w << 1) | (ne << 2);
}
static inline int kappa_of(int rho, const uint8_t* pE, int n, int q) {
    if (!(rho & (rho - 1))) return 1;
    int ea = (q < n) ? pE[q] : 0;
    int eb = (q + 1 < n) ? pE[q + 1] : 0;
    int emax = std::max(ea, eb);
    return std::max(1, emax - 1);
}

// ---- encoder ----
struct HtEncOut { std::vector<uint8_t> seg; int numbps = 0; int umax = 0; };

static void ht_encode_one(const int32_t* coeffs, int w, int h, HtEncOut& out) {
    int64_t maxmag = 0;
    for (int i = 0; i < w * h; i++)
        maxmag = std::max(maxmag, (int64_t)std::abs((int64_t)coeffs[i]));
    int numbps = 0;
    while (maxmag >> numbps) numbps++;
    out.numbps = numbps;
    if (numbps == 0) return;
    out.umax = 1;

    int qw = (w + 1) / 2, qh = (h + 1) / 2;
    MelW mel; VlcW vlc; MagW mag;
    std::vector<uint8_t> prev_sig(qw + 2, 0), prev_E(qw + 2, 0);
    std::vector<uint8_t> cur_sig(qw + 2, 0), cur_E(qw + 2, 0);

    auto sample = [&](int x, int y, uint32_t& v, int& sig, int& E) {
        if (x >= w || y >= h) { v = 0; sig = 0; E = 0; return; }
        int32_t c = coeffs[y * w + x];
        if (c == 0) { v = 0; sig = 0; E = 0; return; }
        v = (((uint32_t)std::abs((int64_t)c) - 1) << 1) | (c < 0 ? 1 : 0);
        sig = 1; E = exponent(v);
    };

    for (int qy = 0; qy < qh; qy++) {
        bool initial = (qy == 0);
        int tblidx = initial ? 0 : 1;
        int y0 = qy * 2;
        std::fill(cur_sig.begin(), cur_sig.end(), 0);
        std::fill(cur_E.begin(), cur_E.end(), 0);
        int c_q = initial ? 0 : ctx_noninit(0, prev_sig.data(), qw + 2, 0);
        for (int qx = 0; qx < qw; qx += 2) {
            struct Quad {
                bool exists = false;
                int rho = 0, Emax = 0, ctx = 0, U = 1, uoff = 0, kappa = 1;
                int e1 = 0, ek = 0;
                bool coded = false;
                uint32_t v[4]; int sig[4]; int E[4];
            } q[2];
            for (int j2 = 0; j2 < 2; j2++) {
                if (qx + j2 >= qw) continue;
                Quad& Q = q[j2];
                Q.exists = true;
                int x0 = (qx + j2) * 2;
                static const int dx[4] = {0, 0, 1, 1}, dy[4] = {0, 1, 0, 1};
                for (int i = 0; i < 4; i++) {
                    sample(x0 + dx[i], y0 + dy[i], Q.v[i], Q.sig[i], Q.E[i]);
                    Q.rho |= Q.sig[i] << i;
                    Q.Emax = std::max(Q.Emax, Q.E[i]);
                }
            }
            // contexts + MEL significance
            for (int j2 = 0; j2 < 2; j2++) {
                if (!q[j2].exists) continue;
                Quad& Q = q[j2];
                if (j2 == 0) Q.ctx = c_q;
                else Q.ctx = initial ? ctx_initial_next(q[0].rho)
                                     : ctx_noninit(qx + 1, prev_sig.data(), qw + 2, q[0].rho);
                if (Q.ctx == 0) {
                    mel.event(Q.rho ? 1 : 0);
                    if (Q.rho == 0) { Q.coded = false; continue; }
                }
                Q.coded = true;
            }
            // kappa, U, uoff
            for (int j2 = 0; j2 < 2; j2++) {
                Quad& Q = q[j2];
                if (!Q.exists || !Q.coded) continue;
                Q.kappa = initial ? 1 : kappa_of(Q.rho, prev_E.data(), qw + 2, qx + j2);
                Q.U = std::max(Q.kappa, Q.Emax);
                Q.uoff = (Q.U - Q.kappa) > 0 ? 1 : 0;
                out.umax = std::max(out.umax, Q.U);
            }
            // VLC codewords
            for (int j2 = 0; j2 < 2; j2++) {
                Quad& Q = q[j2];
                if (!Q.exists || !Q.coded) continue;
                auto& cands = enc_lists[tblidx][Q.ctx][Q.rho][Q.uoff];
                int best_score = -1, best_ln = 99;
                const EncEntry* best = nullptr;
                for (auto& e : cands) {
                    bool ok = true;
                    for (int i = 0; i < 4 && ok; i++) {
                        if ((e.ek >> i) & 1) {
                            if (!((Q.rho >> i) & 1)) { ok = false; break; }
                            int actual = Q.U >= 1 ? (int)((Q.v[i] >> (Q.U - 1)) & 1) : 0;
                            if (((e.e1 >> i) & 1) != actual) ok = false;
                        } else if ((e.e1 >> i) & 1) ok = false;
                    }
                    if (!ok) continue;
                    int score = __builtin_popcount(e.ek);
                    if (score > best_score || (score == best_score && e.ln < best_ln)) {
                        best_score = score; best_ln = e.ln; best = &e;
                    }
                }
                // best must exist (tables complete); fall back defensively
                if (!best) { out.numbps = -1; return; }
                vlc.put(best->cwd, best->ln);
                Q.e1 = best->e1; Q.ek = best->ek;
            }
            // u coding
            int uo0 = (q[0].exists && q[0].coded) ? q[0].uoff : 0;
            int uo1 = (q[1].exists && q[1].coded) ? q[1].uoff : 0;
            int mode = uo0 | (uo1 << 1);
            int p0, pl0, s0, sl0, p1, pl1, s1, sl1;
            if (initial) {
                if (mode == 3) {
                    int u0 = q[0].U - 1, u1 = q[1].U - 1;
                    bool big = u0 > 2 && u1 > 2;
                    mel.event(big ? 1 : 0);
                    if (big) {
                        uvlc_enc(u0 - 2, p0, pl0, s0, sl0);
                        uvlc_enc(u1 - 2, p1, pl1, s1, sl1);
                        vlc.put(p0, pl0); vlc.put(p1, pl1);
                        vlc.put(s0, sl0); vlc.put(s1, sl1);
                    } else if (u0 > 2) {
                        uvlc_enc(u0, p0, pl0, s0, sl0);
                        vlc.put(p0, pl0);
                        vlc.put(u1 - 1, 1);
                        vlc.put(s0, sl0);
                    } else {
                        uvlc_enc(u0, p0, pl0, s0, sl0);
                        uvlc_enc(u1, p1, pl1, s1, sl1);
                        vlc.put(p0, pl0); vlc.put(p1, pl1);
                        vlc.put(s0, sl0); vlc.put(s1, sl1);
                    }
                } else if (mode == 1 || mode == 2) {
                    int u = (mode == 1 ? q[0].U : q[1].U) - 1;
                    uvlc_enc(u, p0, pl0, s0, sl0);
                    vlc.put(p0, pl0); vlc.put(s0, sl0);
                }
            } else {
                if (mode == 3) {
                    uvlc_enc(q[0].U - q[0].kappa, p0, pl0, s0, sl0);
                    uvlc_enc(q[1].U - q[1].kappa, p1, pl1, s1, sl1);
                    vlc.put(p0, pl0); vlc.put(p1, pl1);
                    vlc.put(s0, sl0); vlc.put(s1, sl1);
                } else if (mode == 1 || mode == 2) {
                    int j2 = mode == 1 ? 0 : 1;
                    uvlc_enc(q[j2].U - q[j2].kappa, p0, pl0, s0, sl0);
                    vlc.put(p0, pl0); vlc.put(s0, sl0);
                }
            }
            // MagSgn
            for (int j2 = 0; j2 < 2; j2++) {
                Quad& Q = q[j2];
                if (!Q.exists || !Q.coded || Q.rho == 0) continue;
                for (int i = 0; i < 4; i++)
                    if ((Q.rho >> i) & 1) {
                        int m = Q.U - ((Q.ek >> i) & 1);
                        mag.put(Q.v[i] & ((m < 32 ? (1u << m) : 0u) - 1u), m);
                    }
            }
            // line state (entry straddle: n1 -> byte q, n3 -> byte q+1)
            for (int j2 = 0; j2 < 2; j2++) {
                Quad& Q = q[j2];
                if (!Q.exists) continue;
                int b = qx + j2;
                if (Q.rho & 0x2) {
                    cur_sig[b] |= 1;
                    cur_E[b] = std::max((int)cur_E[b], Q.E[1]);
                }
                if (Q.rho & 0x8) {
                    cur_sig[b + 1] |= 1;
                    cur_E[b + 1] = std::max((int)cur_E[b + 1], Q.E[3]);
                }
            }
            int last_rho = q[1].exists ? q[1].rho : q[0].rho;
            c_q = initial ? ctx_initial_next(last_rho)
                          : ctx_noninit(qx + 2, prev_sig.data(), qw + 2, last_rho);
        }
        prev_sig = cur_sig;
        prev_E = cur_E;
    }

    // assemble
    mel.terminate();
    std::vector<uint8_t> mel_bytes = mel.bytes();

    std::vector<uint8_t>& bits = vlc.bits;
    int nib = 0;
    for (int i = 0; i < 3 && i < (int)bits.size(); i++) nib |= bits[i] << i;
    size_t start;
    if ((nib & 7) == 7) start = 3;
    else {
        if (bits.size() >= 4) nib |= bits[3] << 3;
        start = 4;
    }
    std::vector<uint8_t> packed;
    bool prev_gt = ((nib << 4) | 0x0F) > 0x8F;
    size_t posn = start;
    while (posn < bits.size()) {
        uint32_t chunk7 = 0;
        for (int i = 0; i < 7; i++)
            if (posn + i < bits.size()) chunk7 |= bits[posn + i] << i;
        if (prev_gt && chunk7 == 0x7F) {
            packed.push_back(0x7F); posn += 7; prev_gt = false;
        } else {
            uint32_t b = 0;
            for (int i = 0; i < 8; i++)
                if (posn + i < bits.size()) b |= bits[posn + i] << i;
            packed.push_back((uint8_t)b); posn += 8;
            prev_gt = b > 0x8F;
        }
    }
    mag.flush();
    std::vector<uint8_t>& seg = out.seg;
    seg = mag.buf;
    seg.insert(seg.end(), mel_bytes.begin(), mel_bytes.end());
    for (auto it = packed.rbegin(); it != packed.rend(); ++it) seg.push_back(*it);
    int scup = (int)(mel_bytes.size() + packed.size()) + 2;
    if (scup > 4079) { out.numbps = -1; return; }
    seg.push_back((uint8_t)((nib << 4) | (scup & 0xF)));
    seg.push_back((uint8_t)((scup >> 4) & 0xFF));
}

// ---- decoder ----
static void ht_decode_one(const uint8_t* data, int lcup, int w, int h,
                          int numbps, int32_t* out) {
    std::memset(out, 0, sizeof(int32_t) * (size_t)w * h);
    if (numbps == 0 || lcup < 2) return;
    int scup = (data[lcup - 1] << 4) | (data[lcup - 2] & 0x0F);
    if (scup < 2 || scup > lcup || scup > 4079) return;

    MelR mel(data, lcup, lcup - scup, scup - 1);
    RevR vlc(data, lcup, lcup - 2, scup - 2);
    FwdR mag(data, lcup, 0, lcup - scup, 0xFF);

    int qw = (w + 1) / 2, qh = (h + 1) / 2;
    std::vector<uint8_t> prev_sig(qw + 2, 0), prev_E(qw + 2, 0);
    std::vector<uint8_t> cur_sig(qw + 2, 0), cur_E(qw + 2, 0);
    int run = -1, run_val = 0;
    auto mel_event = [&]() -> int {
        if (run < 0) { run_val = mel.get_run(); run = run_val; }
        run -= 2;
        if (run < 0) {
            int sig = (run == -1) ? 1 : 0;
            run = -1;
            return sig;
        }
        return 0;
    };

    for (int qy = 0; qy < qh; qy++) {
        bool initial = (qy == 0);
        const uint16_t* tbl = initial ? HT_DEC0 : HT_DEC1;
        int y0 = qy * 2;
        std::fill(cur_sig.begin(), cur_sig.end(), 0);
        std::fill(cur_E.begin(), cur_E.end(), 0);
        int c_q = initial ? 0 : ctx_noninit(0, prev_sig.data(), qw + 2, 0);
        for (int qx = 0; qx < qw; qx += 2) {
            int rhos[2] = {0, 0}, e1s[2] = {0, 0}, eks[2] = {0, 0};
            int uoffs[2] = {0, 0};
            bool coded[2] = {false, false};
            for (int j2 = 0; j2 < 2; j2++) {
                if (qx + j2 >= qw) continue;
                int ctx = (j2 == 0) ? c_q
                    : (initial ? ctx_initial_next(rhos[0])
                               : ctx_noninit(qx + 1, prev_sig.data(), qw + 2, rhos[0]));
                int sig = 1;
                if (ctx == 0) sig = mel_event();
                if (!sig) { rhos[j2] = 0; coded[j2] = false; continue; }
                uint32_t window = vlc.fetch() & 0x7F;
                uint16_t e = tbl[(ctx << 7) | window];
                int ln = e & 7;
                if (ln == 0) return;   // invalid stream
                vlc.advance(ln);
                rhos[j2] = (e >> 4) & 0xF;
                uoffs[j2] = (e >> 3) & 1;
                e1s[j2] = (e >> 8) & 0xF;
                eks[j2] = (e >> 12) & 0xF;
                coded[j2] = true;
            }
            int mode = uoffs[0] | (uoffs[1] << 1);
            int U[2] = {1, 1}, kap[2] = {1, 1};
            for (int j2 = 0; j2 < 2; j2++)
                if (!initial && coded[j2])
                    kap[j2] = kappa_of(rhos[j2], prev_E.data(), qw + 2, qx + j2);
            auto take = [&](int n) -> int {
                if (!n) return 0;
                int v = vlc.fetch() & ((1u << n) - 1);
                vlc.advance(n);
                return v;
            };
            auto dec_prefix = [&](int& pl, int& sl, int& base) {
                uint32_t wnd = vlc.fetch() & 7;
                uvlc_dec_prefix(wnd, pl, sl, base);
                vlc.advance(pl);
            };
            if (mode == 1 || mode == 2) {
                int pl, sl, base;
                dec_prefix(pl, sl, base);
                int t = base + take(sl);
                int j2 = (mode == 1) ? 0 : 1;
                U[j2] = initial ? t + 1 : t + kap[j2];
            } else if (mode == 3) {
                if (initial) {
                    int big = mel_event();
                    if (big) {
                        int pl0, sl0, b0, pl1, sl1, b1;
                        dec_prefix(pl0, sl0, b0);
                        dec_prefix(pl1, sl1, b1);
                        U[0] = b0 + take(sl0) + 3;
                        U[1] = b1 + take(sl1) + 3;
                    } else {
                        int pl0, sl0, b0;
                        dec_prefix(pl0, sl0, b0);
                        if (pl0 > 2) {
                            int u1m = take(1);
                            U[0] = b0 + take(sl0) + 1;
                            U[1] = u1m + 2;
                        } else {
                            int pl1, sl1, b1;
                            dec_prefix(pl1, sl1, b1);
                            U[0] = b0 + take(sl0) + 1;
                            U[1] = b1 + take(sl1) + 1;
                        }
                    }
                } else {
                    int pl0, sl0, b0, pl1, sl1, b1;
                    dec_prefix(pl0, sl0, b0);
                    dec_prefix(pl1, sl1, b1);
                    U[0] = b0 + take(sl0) + kap[0];
                    U[1] = b1 + take(sl1) + kap[1];
                }
            }
            for (int j2 = 0; j2 < 2; j2++)
                if (coded[j2] && !uoffs[j2]) U[j2] = initial ? 1 : kap[j2];

            static const int dx[4] = {0, 0, 1, 1}, dy[4] = {0, 1, 0, 1};
            for (int j2 = 0; j2 < 2; j2++) {
                if (qx + j2 >= qw || !coded[j2] || rhos[j2] == 0) continue;
                int x0 = (qx + j2) * 2;
                int Es[4] = {0, 0, 0, 0};
                for (int i = 0; i < 4; i++) {
                    if (!((rhos[j2] >> i) & 1)) continue;
                    int m = U[j2] - ((eks[j2] >> i) & 1);
                    uint32_t val = 0;
                    if (m) {
                        val = mag.fetch() & ((m < 32 ? (1u << m) : 0u) - 1u);
                        mag.advance(m);
                    }
                    uint32_t v = val | ((uint32_t)((e1s[j2] >> i) & 1) << m);
                    uint32_t mu = (v >> 1) + 1;
                    int sgn = v & 1;
                    int xx = x0 + dx[i], yy = y0 + dy[i];
                    if (xx < w && yy < h)
                        out[yy * w + xx] = sgn ? -(int32_t)mu : (int32_t)mu;
                    Es[i] = exponent(v);
                }
                int b = qx + j2;
                if (rhos[j2] & 0x2) {
                    cur_sig[b] |= 1;
                    cur_E[b] = std::max((int)cur_E[b], Es[1]);
                }
                if (rhos[j2] & 0x8) {
                    cur_sig[b + 1] |= 1;
                    cur_E[b + 1] = std::max((int)cur_E[b + 1], Es[3]);
                }
            }
            int last_rho = (qx + 1 < qw) ? rhos[1] : rhos[0];
            c_q = initial ? ctx_initial_next(last_rho)
                          : ctx_noninit(qx + 2, prev_sig.data(), qw + 2, last_rho);
        }
        prev_sig = cur_sig;
        prev_E = cur_E;
    }
}


// VLC-phase cleanup parse (the host half of the DEVICE HT decode path):
// runs the full MEL + CxtVLC + UVLC walk — everything sequentially coupled
// through contexts and line-state exponents — and emits (a) one packed
// uint32 per quad (U | rho<<8 | ek<<12 | e1<<16) and (b) the UNSTUFFED
// MagSgn bit-stream as LSB-first uint32 words.  The per-sample MagSgn
// extraction (the data bulk: variable-length fields at prefix-sum offsets,
// gather-friendly) then runs on device (ops/ht_tpu_decode.py), fused with
// dequantization and the inverse DWT.  MagSgn values are still WALKED here
// because the line-state exponent E_n = bitlen(v_n) of samples n1/n3 feeds
// the next row's kappa (T.814 7.3.7) — but only read, never scattered.
// Returns magsgn word count, or -1 on an invalid stream.
static int ht_parse_one(const uint8_t* data, int lcup, int w, int h,
                        int numbps, uint32_t* qinfo, int qw_pad, int qh_pad,
                        uint32_t* mag_words, int64_t mag_cap_words,
                        int64_t* mag_bits_out) {
    std::memset(qinfo, 0, sizeof(uint32_t) * (size_t)qw_pad * qh_pad);
    *mag_bits_out = 0;
    if (numbps == 0 || lcup < 2) return 0;
    int scup = (data[lcup - 1] << 4) | (data[lcup - 2] & 0x0F);
    if (scup < 2 || scup > lcup || scup > 4079) return -1;

    // unstuff the MagSgn segment (7 payload bits in the byte after 0xFF)
    {
        uint64_t acc = 0; int accb = 0; int64_t wi = 0, bits = 0;
        bool was_ff = false;
        for (int p = 0; p < lcup - scup; p++) {
            uint8_t b = data[p];
            int db = was_ff ? 7 : 8;
            acc |= (uint64_t)(b & ((1u << db) - 1)) << accb;
            accb += db; bits += db;
            if (accb >= 32) {
                if (wi >= mag_cap_words) return -1;
                mag_words[wi++] = (uint32_t)acc;
                acc >>= 32; accb -= 32;
            }
            was_ff = (b == 0xFF);
        }
        if (accb) {
            if (wi >= mag_cap_words) return -1;
            mag_words[wi++] = (uint32_t)acc;
        }
        *mag_bits_out = bits;
        // the VLC walk below validates the stream; remember the word count
        // via bits (ceil div recomputed by the caller)
    }

    MelR mel(data, lcup, lcup - scup, scup - 1);
    RevR vlc(data, lcup, lcup - 2, scup - 2);
    FwdR mag(data, lcup, 0, lcup - scup, 0xFF);

    int qw = (w + 1) / 2, qh = (h + 1) / 2;
    if (qw > qw_pad || qh > qh_pad) return -1;
    std::vector<uint8_t> prev_sig(qw + 2, 0), prev_E(qw + 2, 0);
    std::vector<uint8_t> cur_sig(qw + 2, 0), cur_E(qw + 2, 0);
    int run = -1, run_val = 0;
    auto mel_event = [&]() -> int {
        if (run < 0) { run_val = mel.get_run(); run = run_val; }
        run -= 2;
        if (run < 0) {
            int sig = (run == -1) ? 1 : 0;
            run = -1;
            return sig;
        }
        return 0;
    };

    for (int qy = 0; qy < qh; qy++) {
        bool initial = (qy == 0);
        const uint16_t* tbl = initial ? HT_DEC0 : HT_DEC1;
        std::fill(cur_sig.begin(), cur_sig.end(), 0);
        std::fill(cur_E.begin(), cur_E.end(), 0);
        int c_q = initial ? 0 : ctx_noninit(0, prev_sig.data(), qw + 2, 0);
        for (int qx = 0; qx < qw; qx += 2) {
            int rhos[2] = {0, 0}, e1s[2] = {0, 0}, eks[2] = {0, 0};
            int uoffs[2] = {0, 0};
            bool coded[2] = {false, false};
            for (int j2 = 0; j2 < 2; j2++) {
                if (qx + j2 >= qw) continue;
                int ctx = (j2 == 0) ? c_q
                    : (initial ? ctx_initial_next(rhos[0])
                               : ctx_noninit(qx + 1, prev_sig.data(), qw + 2, rhos[0]));
                int sig = 1;
                if (ctx == 0) sig = mel_event();
                if (!sig) { rhos[j2] = 0; coded[j2] = false; continue; }
                uint32_t window = vlc.fetch() & 0x7F;
                uint16_t e = tbl[(ctx << 7) | window];
                int ln = e & 7;
                if (ln == 0) return -1;   // invalid stream
                vlc.advance(ln);
                rhos[j2] = (e >> 4) & 0xF;
                uoffs[j2] = (e >> 3) & 1;
                e1s[j2] = (e >> 8) & 0xF;
                eks[j2] = (e >> 12) & 0xF;
                coded[j2] = true;
            }
            int mode = uoffs[0] | (uoffs[1] << 1);
            int U[2] = {1, 1}, kap[2] = {1, 1};
            for (int j2 = 0; j2 < 2; j2++)
                if (!initial && coded[j2])
                    kap[j2] = kappa_of(rhos[j2], prev_E.data(), qw + 2, qx + j2);
            auto take = [&](int n) -> int {
                if (!n) return 0;
                int v = vlc.fetch() & ((1u << n) - 1);
                vlc.advance(n);
                return v;
            };
            auto dec_prefix = [&](int& pl, int& sl, int& base) {
                uint32_t wnd = vlc.fetch() & 7;
                uvlc_dec_prefix(wnd, pl, sl, base);
                vlc.advance(pl);
            };
            if (mode == 1 || mode == 2) {
                int pl, sl, base;
                dec_prefix(pl, sl, base);
                int t = base + take(sl);
                int j2 = (mode == 1) ? 0 : 1;
                U[j2] = initial ? t + 1 : t + kap[j2];
            } else if (mode == 3) {
                if (initial) {
                    int big = mel_event();
                    if (big) {
                        int pl0, sl0, b0, pl1, sl1, b1;
                        dec_prefix(pl0, sl0, b0);
                        dec_prefix(pl1, sl1, b1);
                        U[0] = b0 + take(sl0) + 3;
                        U[1] = b1 + take(sl1) + 3;
                    } else {
                        int pl0, sl0, b0;
                        dec_prefix(pl0, sl0, b0);
                        if (pl0 > 2) {
                            int u1m = take(1);
                            U[0] = b0 + take(sl0) + 1;
                            U[1] = u1m + 2;
                        } else {
                            int pl1, sl1, b1;
                            dec_prefix(pl1, sl1, b1);
                            U[0] = b0 + take(sl0) + 1;
                            U[1] = b1 + take(sl1) + 1;
                        }
                    }
                } else {
                    int pl0, sl0, b0, pl1, sl1, b1;
                    dec_prefix(pl0, sl0, b0);
                    dec_prefix(pl1, sl1, b1);
                    U[0] = b0 + take(sl0) + kap[0];
                    U[1] = b1 + take(sl1) + kap[1];
                }
            }
            for (int j2 = 0; j2 < 2; j2++)
                if (coded[j2] && !uoffs[j2]) U[j2] = initial ? 1 : kap[j2];

            for (int j2 = 0; j2 < 2; j2++) {
                if (qx + j2 >= qw || !coded[j2] || rhos[j2] == 0) continue;
                if (U[j2] > 31) return -1;   // magnitudes bound to 30 bits
                                             // (encoder-side invariant), so
                                             // m_n <= 31 fits uint32 shifts
                qinfo[qy * qw_pad + qx + j2] =
                    (uint32_t)U[j2] | ((uint32_t)rhos[j2] << 8)
                    | ((uint32_t)eks[j2] << 12) | ((uint32_t)e1s[j2] << 16);
                int Es[4] = {0, 0, 0, 0};
                for (int i = 0; i < 4; i++) {
                    if (!((rhos[j2] >> i) & 1)) continue;
                    int m = U[j2] - ((eks[j2] >> i) & 1);
                    uint32_t val = 0;
                    if (m) {
                        val = mag.fetch() & ((m < 32 ? (1u << m) : 0u) - 1u);
                        mag.advance(m);
                    }
                    uint32_t v = val | ((uint32_t)((e1s[j2] >> i) & 1) << m);
                    Es[i] = exponent(v);
                }
                int b = qx + j2;
                if (rhos[j2] & 0x2) {
                    cur_sig[b] |= 1;
                    cur_E[b] = std::max((int)cur_E[b], Es[1]);
                }
                if (rhos[j2] & 0x8) {
                    cur_sig[b + 1] |= 1;
                    cur_E[b + 1] = std::max((int)cur_E[b + 1], Es[3]);
                }
            }
            int last_rho = (qx + 1 < qw) ? rhos[1] : rhos[0];
            c_q = initial ? ctx_initial_next(last_rho)
                          : ctx_noninit(qx + 2, prev_sig.data(), qw + 2, last_rho);
        }
        prev_sig = cur_sig;
        prev_E = cur_E;
    }
    return (int)((*mag_bits_out + 31) >> 5);
}


// ---- SigProp / MagRef refinement passes (T.814 7.4) -----------------------
// C++ twins of ops/ht.py encode_sigprop/decode_sigprop/encode_magref/
// decode_magref/encode_refined, byte-identical (differentially tested in
// tests/test_ht_refinement.py).  The reference stubs refinement entirely
// (/root/reference/internal/entropy/ht.go:866-869).

// forward LSB-first bit writer with MagSgn stuffing (7-bit byte after 0xFF)
struct FwdBitW {
    std::vector<uint8_t> buf; uint32_t acc = 0; int nbits = 0; bool last_ff = false;
    inline void put(int v) {
        acc |= (uint32_t)(v & 1) << nbits;
        nbits++;
        while (nbits >= (last_ff ? 7 : 8)) {
            int cap = last_ff ? 7 : 8;
            uint8_t b = acc & ((1u << cap) - 1);
            acc >>= cap; nbits -= cap;
            buf.push_back(b);
            last_ff = (b == 0xFF);
        }
    }
    void flush() {
        if (nbits > 0) {
            int cap = last_ff ? 7 : 8;
            buf.push_back((uint8_t)(acc & ((1u << cap) - 1)));
            acc = 0; nbits = 0;
        }
    }
};

// forward LSB-first reader with MagSgn unstuffing; fill byte 0 past end
struct FwdBitR {
    const uint8_t* d; int n; int pos = 0; uint64_t acc = 0; int bits = 0; bool unst = false;
    FwdBitR(const uint8_t* d_, int n_) : d(d_), n(n_) {}
    inline int bit() {
        while (bits < 1) {
            uint8_t b = pos < n ? d[pos] : 0x00;
            pos++;
            acc |= (uint64_t)b << bits;
            bits += unst ? 7 : 8;
            unst = (b == 0xFF);
        }
        int v = (int)(acc & 1); acc >>= 1; bits--; return v;
    }
};

// backward MRP-style reader (ops/ht.py RevReader(mrp=True))
struct MrpBitR {
    const uint8_t* d; int pos; uint64_t acc = 0; int bits = 0; bool unst = true;
    MrpBitR(const uint8_t* d_, int n_) : d(d_), pos(n_ - 1) {}
    inline int bit() {
        while (bits < 1) {
            uint8_t b = pos >= 0 ? d[pos] : 0x00;
            pos--;
            int db = (unst && (b & 0x7F) == 0x7F) ? 7 : 8;
            acc |= (uint64_t)b << bits;
            bits += db;
            unst = b > 0x8F;
        }
        int v = (int)(acc & 1); acc >>= 1; bits--; return v;
    }
};

// pack a bit list for the backward-growing MRP stream (ops/ht.py
// _pack_backward_bits, prev_gt starts true); returns bytes in file order
static std::vector<uint8_t> pack_backward_bits(const std::vector<uint8_t>& bits) {
    std::vector<uint8_t> packed;
    size_t pos = 0; bool prev_gt = true;
    while (pos < bits.size()) {
        uint32_t chunk7 = 0;
        for (int i = 0; i < 7; i++)
            if (pos + i < bits.size()) chunk7 |= (uint32_t)bits[pos + i] << i;
        if (prev_gt && chunk7 == 0x7F) {
            packed.push_back(0x7F); pos += 7; prev_gt = false;
        } else {
            uint32_t b = 0;
            for (int i = 0; i < 8; i++)
                if (pos + i < bits.size()) b |= (uint32_t)bits[pos + i] << i;
            packed.push_back((uint8_t)b); pos += 8; prev_gt = b > 0x8F;
        }
    }
    std::reverse(packed.begin(), packed.end());
    return packed;
}

static inline bool has_sig_neighbor(const std::vector<uint8_t>& sig,
                                    int y, int x, int h, int w) {
    for (int dy = -1; dy <= 1; dy++) {
        int yy = y + dy;
        if (yy < 0 || yy >= h) continue;
        for (int dx = -1; dx <= 1; dx++) {
            if (!dy && !dx) continue;
            int xx = x + dx;
            if (xx >= 0 && xx < w && sig[(size_t)yy * w + xx]) return true;
        }
    }
    return false;
}

// SigProp scan shared by stats/encode/decode: stripe of 4 rows, aligned
// groups of 4 columns, columns left-to-right top-down; group significance
// bits first, then the group's new signs in discovery order
template <typename FBit, typename FSign>
static void sigprop_scan(std::vector<uint8_t>& sig, int w, int h,
                         FBit&& on_member, FSign&& on_sign) {
    std::vector<std::pair<int,int>> newly;
    for (int y0 = 0; y0 < h; y0 += 4) {
        int sh = std::min(4, h - y0);
        for (int gx = 0; gx < w; gx += 4) {
            newly.clear();
            for (int x = gx; x < std::min(gx + 4, w); x++)
                for (int dy = 0; dy < sh; dy++) {
                    int y = y0 + dy;
                    if (sig[(size_t)y * w + x]) continue;
                    if (!has_sig_neighbor(sig, y, x, h, w)) continue;
                    if (on_member(y, x)) {
                        sig[(size_t)y * w + x] = 1;
                        newly.push_back({y, x});
                    }
                }
            for (auto& yx : newly) on_sign(yx.first, yx.second);
        }
    }
}

struct HtRefOut {
    std::vector<uint8_t> cup, ref;   // ref = spp ++ mrp
    int numbps = 0, umax = 0, lspp = 0;
    int refined = 0;                 // 1 = 3-pass set, 0 = cleanup-only
    double d_total = 0, resid_cup = 0, resid_spp = 0, resid_mrp = 0;
};

static void ht_encode_refined_one(const int32_t* c, int w, int h,
                                  int require_exact, HtRefOut& out) {
    const size_t n = (size_t)w * h;
    int64_t mx = 0;
    for (size_t i = 0; i < n; i++)
        mx = std::max(mx, (int64_t)std::abs((int64_t)c[i]));
    HtEncOut eo;
    if (mx <= 1) {                            // nothing to refine
        ht_encode_one(c, w, h, eo);
        out.cup = std::move(eo.seg); out.numbps = eo.numbps ? 1 : 0;
        out.umax = eo.umax; out.refined = 0;
        return;
    }
    std::vector<int32_t> halved(n);
    std::vector<uint8_t> sigma(n);
    for (size_t i = 0; i < n; i++) {
        int64_t m = std::abs((int64_t)c[i]) >> 1;
        halved[i] = (int32_t)(c[i] < 0 ? -m : m);
        sigma[i] = m != 0;
    }
    ht_encode_one(halved.data(), w, h, eo);
    if (eo.numbps == 0) {                     // no seeds for SigProp
        HtEncOut full;
        ht_encode_one(c, w, h, full);
        out.cup = std::move(full.seg); out.numbps = full.numbps ? 1 : 0;
        out.umax = full.umax; out.refined = 0;
        return;
    }
    // membership stats (lossless feasibility): unreachable odd units
    int n_lost = 0, n_new = 0;
    {
        std::vector<uint8_t> s2(sigma);
        for (int y0 = 0; y0 < h; y0 += 4) {
            int sh = std::min(4, h - y0);
            for (int gx = 0; gx < w; gx += 4)
                for (int x = gx; x < std::min(gx + 4, w); x++)
                    for (int dy = 0; dy < sh; dy++) {
                        int y = y0 + dy;
                        if (s2[(size_t)y * w + x]) continue;
                        int odd = (int)(std::abs((int64_t)c[(size_t)y * w + x]) & 1);
                        if (!has_sig_neighbor(s2, y, x, h, w)) { n_lost += odd; continue; }
                        if (odd) { s2[(size_t)y * w + x] = 1; n_new++; }
                    }
        }
    }
    if (n_lost && require_exact) {            // lossless demands fallback
        HtEncOut full;
        ht_encode_one(c, w, h, full);
        out.cup = std::move(full.seg); out.numbps = full.numbps ? 1 : 0;
        out.umax = full.umax; out.refined = 0;
        return;
    }
    // SigProp bytes (bitplane 0 of |c|, discovery-ordered signs)
    FwdBitW spp;
    {
        std::vector<uint8_t> s2(sigma);
        sigprop_scan(s2, w, h,
            [&](int y, int x) {
                int bit = (int)(std::abs((int64_t)c[(size_t)y * w + x]) & 1);
                spp.put(bit);
                return bit != 0;
            },
            [&](int y, int x) { spp.put(c[(size_t)y * w + x] < 0 ? 1 : 0); });
        spp.flush();
    }
    // MagRef bits: bit 0 of cleanup-significant samples, stripe columns
    std::vector<uint8_t> mr_bits;
    for (int y0 = 0; y0 < h; y0 += 4) {
        int sh = std::min(4, h - y0);
        for (int x = 0; x < w; x++)
            for (int dy = 0; dy < sh; dy++) {
                int y = y0 + dy;
                if (sigma[(size_t)y * w + x])
                    mr_bits.push_back((uint8_t)(std::abs(
                        (int64_t)c[(size_t)y * w + x]) & 1));
            }
    }
    std::vector<uint8_t> mrp = pack_backward_bits(mr_bits);
    out.cup = std::move(eo.seg);
    out.lspp = (int)spp.buf.size();
    out.ref = std::move(spp.buf);
    out.ref.insert(out.ref.end(), mrp.begin(), mrp.end());
    out.numbps = 2; out.umax = eo.umax; out.refined = 1;
    // distortion model (models/entropy_backend._encode_ht_refined)
    double d_total = 0, resid_cup = 0;
    for (size_t i = 0; i < n; i++) {
        double m = (double)std::abs((int64_t)c[i]);
        d_total += m * m;
        if (sigma[i]) {
            double odd = (double)(std::abs((int64_t)c[i]) & 1);
            resid_cup += odd * odd;
        } else resid_cup += m * m;
    }
    out.d_total = d_total;
    out.resid_cup = resid_cup;
    out.resid_spp = resid_cup - (double)n_new;
    out.resid_mrp = (double)n_lost;
}

static void ht_decode_refined_one(const uint8_t* data, int lcup, int lref,
                                  int w, int h, int numbps, int num_passes,
                                  int32_t* out) {
    const size_t n = (size_t)w * h;
    if (num_passes <= 1 || numbps <= 1 || lref <= 0) {
        ht_decode_one(data, lcup, w, h, numbps, out);
        if (numbps > 1)
            for (size_t i = 0; i < n; i++)
                out[i] = (int32_t)((int64_t)out[i] << (numbps - 1));
        return;
    }
    int shift = numbps - 1;
    ht_decode_one(data, lcup, w, h, numbps, out);
    std::vector<uint8_t> sigma(n);
    std::vector<int64_t> v(n);
    for (size_t i = 0; i < n; i++) {
        sigma[i] = out[i] != 0;
        v[i] = (int64_t)out[i] << shift;
    }
    const uint8_t* ref = data + lcup;
    if (num_passes >= 3) {                     // MagRef (backward)
        MrpBitR rd(ref, lref);
        for (int y0 = 0; y0 < h; y0 += 4) {
            int sh = std::min(4, h - y0);
            for (int x = 0; x < w; x++)
                for (int dy = 0; dy < sh; dy++) {
                    int y = y0 + dy;
                    size_t i = (size_t)y * w + x;
                    if (!sigma[i]) continue;
                    if (rd.bit()) {
                        int64_t mag = std::abs(v[i]) | (1ll << (shift - 1));
                        v[i] = v[i] < 0 ? -mag : mag;
                    }
                }
        }
    }
    {                                          // SigProp (forward, fill 0)
        FwdBitR rd(ref, lref);
        std::vector<uint8_t> s2(sigma);
        sigprop_scan(s2, w, h,
            [&](int, int) { return rd.bit() != 0; },
            [&](int y, int x) {
                size_t i = (size_t)y * w + x;
                int sgn = rd.bit();
                int64_t mag = 1ll << (shift - 1);
                v[i] = sgn ? -mag : mag;
            });
    }
    for (size_t i = 0; i < n; i++) out[i] = (int32_t)v[i];
}

} // namespace ht

extern "C" {

int ht_encode_batch(
    const int32_t* coeffs, const int64_t* coeff_offsets,
    const int32_t* ws, const int32_t* hs, int32_t n_blocks,
    uint8_t* out_data, const int64_t* out_offsets,
    int32_t* numbps_out, int32_t* umax_out, int32_t* datalen_out,
    int32_t* n_threads_unused, int32_t n_threads)
{
    (void)n_threads_unused;
    std::atomic<int> err{0};
    parallel_for(n_blocks, n_threads, [&](int i) {
        ht::HtEncOut eo;
        ht::ht_encode_one(coeffs + coeff_offsets[i], ws[i], hs[i], eo);
        int64_t cap = out_offsets[i + 1] - out_offsets[i];
        if (eo.numbps < 0 || (int64_t)eo.seg.size() > cap) {
            err.store(-(i + 1));
            return;
        }
        std::memcpy(out_data + out_offsets[i], eo.seg.data(), eo.seg.size());
        numbps_out[i] = eo.numbps;
        umax_out[i] = eo.umax;
        datalen_out[i] = (int)eo.seg.size();
    });
    return err.load();
}

int ht_decode_batch(
    const uint8_t* data, const int64_t* data_offsets, const int32_t* data_lens,
    const int32_t* ws, const int32_t* hs, const int32_t* numbps,
    int32_t n_blocks, int32_t* out, const int64_t* out_offsets,
    int32_t n_threads)
{
    parallel_for(n_blocks, n_threads, [&](int i) {
        ht::ht_decode_one(data + data_offsets[i], data_lens[i], ws[i], hs[i],
                          numbps[i], out + out_offsets[i]);
    });
    return 0;
}


int ht_encode_refined_batch(
    const int32_t* coeffs, const int64_t* coeff_offsets,
    const int32_t* ws, const int32_t* hs, int32_t n_blocks,
    int32_t require_exact,
    uint8_t* out_data, const int64_t* out_offsets,
    int32_t* numbps_out, int32_t* umax_out,
    int32_t* lcup_out, int32_t* lspp_out, int32_t* lref_out,
    int32_t* refined_out, double* dist_out /* [n,4] */,
    int32_t n_threads)
{
    std::atomic<int> err{0};
    parallel_for(n_blocks, n_threads, [&](int i) {
        ht::HtRefOut ro;
        ht::ht_encode_refined_one(coeffs + coeff_offsets[i], ws[i], hs[i],
                                  require_exact, ro);
        int64_t cap = out_offsets[i + 1] - out_offsets[i];
        int64_t need = (int64_t)ro.cup.size() + (int64_t)ro.ref.size();
        if (need > cap) { err.store(-(i + 1)); return; }
        std::memcpy(out_data + out_offsets[i], ro.cup.data(), ro.cup.size());
        std::memcpy(out_data + out_offsets[i] + ro.cup.size(),
                    ro.ref.data(), ro.ref.size());
        numbps_out[i] = ro.numbps;
        umax_out[i] = ro.umax;
        lcup_out[i] = (int32_t)ro.cup.size();
        lspp_out[i] = ro.lspp;
        lref_out[i] = (int32_t)ro.ref.size();
        refined_out[i] = ro.refined;
        dist_out[(size_t)i * 4 + 0] = ro.d_total;
        dist_out[(size_t)i * 4 + 1] = ro.resid_cup;
        dist_out[(size_t)i * 4 + 2] = ro.resid_spp;
        dist_out[(size_t)i * 4 + 3] = ro.resid_mrp;
    });
    return err.load();
}

int ht_decode_refined_batch(
    const uint8_t* data, const int64_t* data_offsets,
    const int32_t* lcup, const int32_t* lref,
    const int32_t* ws, const int32_t* hs, const int32_t* numbps,
    const int32_t* num_passes,
    int32_t n_blocks, int32_t* out, const int64_t* out_offsets,
    int32_t n_threads)
{
    parallel_for(n_blocks, n_threads, [&](int i) {
        ht::ht_decode_refined_one(data + data_offsets[i], lcup[i], lref[i],
                                  ws[i], hs[i], numbps[i], num_passes[i],
                                  out + out_offsets[i]);
    });
    return 0;
}


// MQ coding of pre-extracted decision streams (packed ctx | bit<<5 bytes,
// the device decision kernel's output format — ops/ebcot_device.py).  The
// hybrid half of the VERDICT r3 ablation: device computes decisions, host
// runs only the irreducibly-serial MQ state machine.
int mq_encode_streams_batch(
    const uint8_t* decisions, const int64_t* dec_offsets,
    int32_t n_streams,
    uint8_t* out_data, const int64_t* out_offsets, int32_t* out_lens,
    int32_t n_threads)
{
    std::atomic<int> err{0};
    parallel_for(n_streams, n_threads, [&](int i) {
        MQEnc mq; mq.init();
        const uint8_t* d = decisions + dec_offsets[i];
        int64_t n = dec_offsets[i + 1] - dec_offsets[i];
        for (int64_t k = 0; k < n; k++)
            mq.encode((d[k] >> 5) & 1, d[k] & 0x1F);
        std::vector<uint8_t> seg;
        if (n > 0) mq.flush_to(seg);
        int64_t cap = out_offsets[i + 1] - out_offsets[i];
        if ((int64_t)seg.size() > cap) { err.store(-(i + 1)); return; }
        std::memcpy(out_data + out_offsets[i], seg.data(), seg.size());
        out_lens[i] = (int32_t)seg.size();
    });
    return err.load();
}

} // extern "C"

// ===========================================================================
// HT cleanup segment serializer for the device field kernel (ops/ht_tpu.py).
//
// The device computes every coding decision data-parallel and emits three
// unstuffed bit-streams per block (MagSgn, VLC in decode order, MEL events);
// this serializer only applies the byte-oriented tails: MEL adaptive
// run-length coding, the T.814 stuffing rules, and segment assembly with the
// SCUP trailer.  Bit-identical to ops/ht.py `encode_cleanup` (tested via
// tests/test_ht_tpu.py).
// ===========================================================================
namespace htser {

struct BitSrc {
    const uint32_t* w;
    int64_t nwords;
    int64_t nbits;
    int64_t pos = 0;
    int64_t remaining() const { return nbits - pos; }
    uint32_t take(int n) {
        if (n <= 0) return 0;
        int64_t p = pos; pos += n;
        int64_t wi = p >> 5; int b = (int)(p & 31);
        uint64_t v = wi < nwords ? ((uint64_t)w[wi] >> b) : 0;
        if (b + n > 32 && wi + 1 < nwords)
            v |= (uint64_t)w[wi + 1] << (32 - b);
        return (uint32_t)(v & ((1ull << n) - 1));
    }
};

// returns segment length, or -1 on overflow of `cap`
static int serialize_one(
    const uint32_t* ms_w, int64_t ms_nw, int64_t ms_bits,
    const uint32_t* vlc_w, int64_t vlc_nw, int64_t vlc_bits,
    const uint32_t* mel_w, int64_t mel_nw, int64_t mel_bits,
    int numbps, uint8_t* out, int64_t cap)
{
    if (numbps == 0) return 0;
    int64_t n = 0;

    // MagSgn: LSB-first bytes, 7-bit cap after 0xFF
    BitSrc ms{ms_w, ms_nw, ms_bits};
    bool last_ff = false;
    while (ms.remaining() > 0) {
        int capb = last_ff ? 7 : 8;
        int take = (int)std::min<int64_t>(capb, ms.remaining());
        uint8_t b = (uint8_t)ms.take(take);
        if (n >= cap) return -1;
        out[n++] = b;
        last_ff = (b == 0xFF);
    }
    int64_t melvlc_start = n;

    // MEL: replay events through the adaptive coder
    ht::MelW mel;
    BitSrc ev{mel_w, mel_nw, mel_bits};
    for (int64_t i = 0; i < mel_bits; i++) mel.event((int)ev.take(1));
    mel.terminate();
    {
        // byte-pack per ops/ht.py: no forced byte when the bit list is empty
        uint32_t acc = 0; int nb = 0; bool lf = false;
        std::vector<uint8_t> mb;
        for (uint8_t bit : mel.bits) {
            int capb = lf ? 7 : 8;
            acc = (acc << 1) | bit;
            if (++nb == capb) {
                mb.push_back((uint8_t)acc); lf = (acc == 0xFF);
                acc = 0; nb = 0;
            }
        }
        if (nb) {
            int capb = (!mb.empty() && mb.back() == 0xFF) ? 7 : 8;
            mb.push_back((uint8_t)((acc << (capb - nb)) & 0xFF));
        }
        if (!mb.empty() && mb.back() == 0xFF) mb.push_back(0);
        if (n + (int64_t)mb.size() > cap) return -1;
        std::memcpy(out + n, mb.data(), mb.size());
        n += mb.size();
    }

    // VLC: nibble + backward stuffed packing, bytes reversed into the stream
    BitSrc vs{vlc_w, vlc_nw, vlc_bits};
    uint32_t nib = vs.take((int)std::min<int64_t>(3, vs.remaining()));
    if ((nib & 7) != 7 && vs.remaining() > 0)
        nib |= vs.take(1) << 3;
    std::vector<uint8_t> packed;
    bool prev_gt = ((nib << 4) | 0x0F) > 0x8F;
    while (vs.remaining() > 0) {
        int64_t save = vs.pos;
        uint32_t c7 = vs.take((int)std::min<int64_t>(7, vs.remaining()));
        if (prev_gt && c7 == 0x7F) {
            packed.push_back(0x7F);
            prev_gt = false;
        } else {
            vs.pos = save;
            uint8_t b = (uint8_t)vs.take((int)std::min<int64_t>(8, vs.remaining()));
            packed.push_back(b);
            prev_gt = b > 0x8F;
        }
    }
    if (n + (int64_t)packed.size() + 2 > cap) return -1;
    for (auto it = packed.rbegin(); it != packed.rend(); ++it) out[n++] = *it;

    int64_t scup = (n - melvlc_start) + 2;
    if (scup > 4079) return -2;
    out[n++] = (uint8_t)((nib << 4) | (scup & 0xF));
    out[n++] = (uint8_t)((scup >> 4) & 0xFF);
    return (int)n;
}

} // namespace htser

extern "C" {

// Serialize a batch of blocks from packed device streams.
// words: one flat uint32 array; per-block stream i occupies
// [ms_off[i], ms_off[i]+ms_nw), etc.  Offsets/counts in words.
int ht_serialize_batch(
    const uint32_t* words,
    const int64_t* ms_off, const int64_t* ms_nw, const int32_t* ms_bits,
    const int64_t* vlc_off, const int64_t* vlc_nw, const int32_t* vlc_bits,
    const int64_t* mel_off, const int64_t* mel_nw, const int32_t* mel_bits,
    const int32_t* numbps, int32_t n_blocks,
    uint8_t* out_data, const int64_t* out_offsets, int32_t* out_len,
    int32_t n_threads)
{
    std::atomic<int> err{0};
    parallel_for(n_blocks, n_threads, [&](int i) {
        int r = htser::serialize_one(
            words + ms_off[i], ms_nw[i], ms_bits[i],
            words + vlc_off[i], vlc_nw[i], vlc_bits[i],
            words + mel_off[i], mel_nw[i], mel_bits[i],
            numbps[i], out_data + out_offsets[i],
            out_offsets[i + 1] - out_offsets[i]);
        if (r < 0) err.store(-(i + 1));
        else out_len[i] = r;
    });
    return err.load();
}

} // extern "C"

// ===========================================================================
// Tier-2 single-layer fast path (ISO/IEC 15444-1 B.9-B.12 subset).
//
// The production throughput configuration (HT blocks, one quality layer, no
// SOP/EPH, one precinct per band) needs only a narrow slice of T2: every
// code-block contributes at most one codeword segment to exactly one packet.
// This implements that slice natively — standard 2-D tag trees (B.10.2),
// Table B.4 numpasses, Lblock length coding — replacing the Python packet
// walk in models/encoder.py::_assemble_packets for eligible streams.
// Multi-layer / PCRD / SOP / EPH / packed-header streams stay on the general
// Python path.  (Reference analog: /root/reference/internal/tcd/t2.go, whose
// tag-tree and length coding are non-conformant; this is the standard form.)
// ===========================================================================
namespace t2n {

struct BitW {   // MSB-first writer with 0xFF stuffing (utils/bio.py BitWriter)
    std::vector<uint8_t> buf;
    uint32_t acc = 0;
    int n = 0;
    int cap() const { return (!buf.empty() && buf.back() == 0xFF) ? 7 : 8; }
    void bit(int b) {
        acc = (acc << 1) | (b & 1);
        if (++n == cap()) { buf.push_back((uint8_t)acc); acc = 0; n = 0; }
    }
    void bits(uint32_t v, int count) {
        for (int i = count - 1; i >= 0; i--) bit((v >> i) & 1);
    }
    void flush() {
        if (n > 0) {
            int c = cap();
            buf.push_back((uint8_t)((acc << (c - n)) & 0xFF));
            acc = 0; n = 0;
        }
        if (!buf.empty() && buf.back() == 0xFF) buf.push_back(0);
    }
};

struct BitR {   // MSB-first reader mirroring BitW (truncated reads feed 0s)
    const uint8_t* d;
    int64_t len;
    int64_t pos = 0;
    uint32_t acc = 0;
    int n = 0;
    uint8_t prev = 0;
    void load() {
        uint8_t b = 0;
        if (pos < len) b = d[pos++];
        int cap = (prev == 0xFF) ? 7 : 8;
        acc = b & ((1u << cap) - 1);
        n = cap;
        prev = b;
    }
    int bit() {
        if (n == 0) load();
        n--;
        return (acc >> n) & 1;
    }
    uint32_t bits(int count) {
        uint32_t v = 0;
        for (int i = 0; i < count; i++) v = (v << 1) | bit();
        return v;
    }
    void align() {   // byte-align; skip the stuffed byte after 0xFF
        acc = 0; n = 0;
        if (prev == 0xFF) {
            if (pos < len) prev = d[pos++];
            else prev = 0;
        }
    }
};

static const int TT_INF = 999999999;

struct TagTree {   // standard 2-D tag tree (tcd/tagtree.py port)
    int w = 0, h = 0;
    std::vector<int> val, low, parent;
    std::vector<uint8_t> known;

    void init(int w_, int h_) {
        w = w_; h = h_;
        std::vector<std::pair<int,int>> sizes{{w, h}};
        while (sizes.back() != std::make_pair(1, 1)) {
            auto [lw, lh] = sizes.back();
            sizes.push_back({(lw + 1) / 2, (lh + 1) / 2});
        }
        std::vector<int> off;
        int total = 0;
        for (auto [lw, lh] : sizes) { off.push_back(total); total += lw * lh; }
        val.assign(total, TT_INF);
        low.assign(total, 0);
        known.assign(total, 0);
        parent.assign(total, -1);
        for (size_t lev = 0; lev + 1 < sizes.size(); lev++) {
            auto [lw, lh] = sizes[lev];
            int pw = sizes[lev + 1].first;
            for (int y = 0; y < lh; y++)
                for (int x = 0; x < lw; x++)
                    parent[off[lev] + y * lw + x] =
                        off[lev + 1] + (y / 2) * pw + (x / 2);
        }
    }
    void set_value(int x, int y, int v) {
        int i = y * w + x;
        val[i] = v;
        while (parent[i] >= 0) {
            int p = parent[i];
            if (v < val[p]) { val[p] = v; i = p; }
            else break;
        }
    }
    // path root->leaf into scratch
    int path(int x, int y, int* out) const {
        int n = 0, i = y * w + x;
        out[n++] = i;
        while (parent[i] >= 0) { i = parent[i]; out[n++] = i; }
        for (int a = 0, b = n - 1; a < b; a++, b--) std::swap(out[a], out[b]);
        return n;
    }
    void encode(BitW& bw, int x, int y, int threshold) {
        int p[32];
        int np = path(x, y, p);
        int lo = 0;
        for (int k = 0; k < np; k++) {
            int i = p[k];
            if (lo < low[i]) lo = low[i];
            while (lo < threshold) {
                if (lo >= val[i]) {
                    if (!known[i]) { bw.bit(1); known[i] = 1; }
                    break;
                }
                bw.bit(0);
                lo++;
            }
            low[i] = lo;
            if (lo >= threshold) break;
        }
    }
    bool decode(BitR& br, int x, int y, int threshold) {
        int p[32];
        int np = path(x, y, p);
        int lo = 0, leaf = p[0];
        for (int k = 0; k < np; k++) {
            int i = p[k];
            leaf = i;
            if (lo < low[i]) lo = low[i];
            while (lo < threshold && lo < val[i]) {
                if (br.bit()) { val[i] = lo; known[i] = 1; }
                else lo++;
            }
            low[i] = lo;
            if (lo >= threshold) break;
        }
        return val[leaf] < threshold;
    }
    int leaf(int x, int y) const { return val[y * w + x]; }
};

static void enc_num_passes(BitW& bw, int n) {   // Table B.4
    if (n == 1) bw.bit(0);
    else if (n == 2) bw.bits(0b10, 2);
    else if (n <= 5) { bw.bits(0b11, 2); bw.bits(n - 3, 2); }
    else if (n <= 36) { bw.bits(0b11, 2); bw.bits(0b11, 2); bw.bits(n - 6, 5); }
    else { bw.bits(0b11, 2); bw.bits(0b11, 2); bw.bits(0b11111, 5);
           bw.bits(n - 37, 7); }
}

static int dec_num_passes(BitR& br) {
    if (br.bit() == 0) return 1;
    if (br.bit() == 0) return 2;
    uint32_t v = br.bits(2);
    if (v < 3) return 3 + (int)v;
    v = br.bits(5);
    if (v < 31) return 6 + (int)v;
    return 37 + (int)br.bits(7);
}

static int bitlen32(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

// Geometry walk shared by encode/decode: packets -> band-precincts -> blocks.
struct Geom {
    int n_packets;
    const int32_t* pkt_nbp;
    const int32_t* bp_cbw;
    const int32_t* bp_cbh;
    const int32_t* bp_nblocks;
    const int32_t* bp_blocks;      // flattened frame-local block ids
    const int32_t* bp_block_xy;    // flattened (cbx, cby) pairs per block
    int total_bp;
    std::vector<int> bp_block_off; // per-bp offset into bp_blocks

    void finish() {
        total_bp = 0;
        for (int p = 0; p < n_packets; p++) total_bp += pkt_nbp[p];
        bp_block_off.resize(total_bp + 1);
        bp_block_off[0] = 0;
        for (int b = 0; b < total_bp; b++)
            bp_block_off[b + 1] = bp_block_off[b] + bp_nblocks[b];
    }
};

// Encode one frame: headers + bodies -> out.  Returns body length or -1.
static int64_t encode_frame(
    const Geom& g, const int32_t* zbp, const int32_t* numbps,
    const uint8_t* segs, const int64_t* seg_off, const int32_t* seg_len,
    uint8_t* out, int64_t cap)
{
    std::vector<TagTree> incl(g.total_bp), imsb(g.total_bp);
    for (int b = 0; b < g.total_bp; b++) {
        if (g.bp_cbw[b] <= 0 || g.bp_cbh[b] <= 0) continue;
        incl[b].init(g.bp_cbw[b], g.bp_cbh[b]);
        imsb[b].init(g.bp_cbw[b], g.bp_cbh[b]);
        for (int k = g.bp_block_off[b]; k < g.bp_block_off[b + 1]; k++) {
            int id = g.bp_blocks[k];
            int cbx = g.bp_block_xy[2 * k], cby = g.bp_block_xy[2 * k + 1];
            incl[b].set_value(cbx, cby, numbps[id] > 0 ? 0 : 1);
            imsb[b].set_value(cbx, cby, zbp[id]);
        }
    }
    int64_t n = 0;
    int bpi = 0;
    for (int p = 0; p < g.n_packets; p++) {
        int nbp = g.pkt_nbp[p];
        bool any = false;
        for (int b = bpi; b < bpi + nbp && !any; b++)
            for (int k = g.bp_block_off[b]; k < g.bp_block_off[b + 1]; k++)
                if (numbps[g.bp_blocks[k]] > 0) { any = true; break; }
        BitW bw;
        if (!any) {
            bw.bit(0);
            bw.flush();
            if (n + (int64_t)bw.buf.size() > cap) return -1;
            std::memcpy(out + n, bw.buf.data(), bw.buf.size());
            n += bw.buf.size();
            bpi += nbp;
            continue;
        }
        bw.bit(1);
        // header
        for (int b = bpi; b < bpi + nbp; b++) {
            for (int k = g.bp_block_off[b]; k < g.bp_block_off[b + 1]; k++) {
                int id = g.bp_blocks[k];
                int cbx = g.bp_block_xy[2 * k], cby = g.bp_block_xy[2 * k + 1];
                incl[b].encode(bw, cbx, cby, 1);
                if (numbps[id] <= 0) continue;
                imsb[b].encode(bw, cbx, cby, zbp[id] + 1);
                enc_num_passes(bw, 1);
                int len = seg_len[id];
                int kk = std::max(3, std::max(1, bitlen32((uint32_t)len)));
                for (int i = 0; i < kk - 3; i++) bw.bit(1);
                bw.bit(0);
                bw.bits((uint32_t)len, kk);
            }
        }
        bw.flush();
        if (n + (int64_t)bw.buf.size() > cap) return -1;
        std::memcpy(out + n, bw.buf.data(), bw.buf.size());
        n += bw.buf.size();
        // bodies
        for (int b = bpi; b < bpi + nbp; b++) {
            for (int k = g.bp_block_off[b]; k < g.bp_block_off[b + 1]; k++) {
                int id = g.bp_blocks[k];
                if (numbps[id] <= 0) continue;
                int len = seg_len[id];
                if (n + len > cap) return -1;
                std::memcpy(out + n, segs + seg_off[id], len);
                n += len;
            }
        }
        bpi += nbp;
    }
    return n;
}

// Decode one frame's packets; per block: numbps (0 if excluded), body
// offset/length into `data`.  Returns consumed bytes, or -1 on anything the
// fast path does not model (npasses != 1, truncation).
static int64_t decode_frame(
    const Geom& g, const int32_t* mb, const uint8_t* data, int64_t dlen,
    int32_t* numbps_out, int64_t* body_off, int32_t* body_len)
{
    std::vector<TagTree> incl(g.total_bp), imsb(g.total_bp);
    for (int b = 0; b < g.total_bp; b++)
        if (g.bp_cbw[b] > 0 && g.bp_cbh[b] > 0) {
            incl[b].init(g.bp_cbw[b], g.bp_cbh[b]);
            imsb[b].init(g.bp_cbw[b], g.bp_cbh[b]);
        }
    int64_t pos = 0;
    int bpi = 0;
    std::vector<int> inc_ids;
    for (int p = 0; p < g.n_packets; p++) {
        int nbp = g.pkt_nbp[p];
        if (pos >= dlen) return -1;
        BitR br{data + pos, dlen - pos};
        inc_ids.clear();
        if (br.bit()) {
            for (int b = bpi; b < bpi + nbp; b++) {
                for (int k = g.bp_block_off[b]; k < g.bp_block_off[b + 1];
                     k++) {
                    int id = g.bp_blocks[k];
                    int cbx = g.bp_block_xy[2 * k];
                    int cby = g.bp_block_xy[2 * k + 1];
                    if (!incl[b].decode(br, cbx, cby, 1)) continue;
                    int t = 1;
                    while (!imsb[b].decode(br, cbx, cby, t)) t++;
                    int zb = imsb[b].leaf(cbx, cby);
                    int np = dec_num_passes(br);
                    if (np != 1) return -1;      // beyond the fast path
                    int lblock = 3;
                    while (br.bit()) lblock++;
                    int len = (int)br.bits(lblock);
                    numbps_out[id] = mb[id] - zb;
                    body_len[id] = len;
                    inc_ids.push_back(id);
                }
            }
        }
        br.align();
        pos += br.pos;
        for (int id : inc_ids) {
            body_off[id] = pos;
            pos += body_len[id];
            if (pos > dlen) return -1;
        }
        bpi += nbp;
    }
    return pos;
}

} // namespace t2n

extern "C" {

// Fused serialize + T2 assemble: device stream pool -> per-frame tile bodies.
int ht_t2_encode_frames(
    const uint32_t* words,
    const int64_t* ms_off, const int64_t* ms_nw, const int32_t* ms_bits,
    const int64_t* vlc_off, const int64_t* vlc_nw, const int32_t* vlc_bits,
    const int64_t* mel_off, const int64_t* mel_nw, const int32_t* mel_bits,
    const int32_t* numbps, const int32_t* zbp,
    int32_t n_frames, int32_t nb,
    int32_t n_packets, const int32_t* pkt_nbp,
    const int32_t* bp_cbw, const int32_t* bp_cbh, const int32_t* bp_nblocks,
    const int32_t* bp_blocks, const int32_t* bp_block_xy,
    uint8_t* out, const int64_t* out_offsets, int64_t* out_lens,
    int32_t n_threads)
{
    t2n::Geom g{n_packets, pkt_nbp, bp_cbw, bp_cbh, bp_nblocks, bp_blocks,
                bp_block_xy};
    g.finish();
    std::atomic<int> err{0};
    parallel_for(n_frames, n_threads, [&](int f) {
        int base = f * nb;
        // serialize this frame's segments into a scratch arena
        std::vector<int64_t> soff(nb + 1, 0);
        for (int i = 0; i < nb; i++) {
            int gi = base + i;
            int64_t capb = ms_bits[gi] / 7 + vlc_bits[gi] / 7
                           + mel_bits[gi] + 32;
            soff[i + 1] = soff[i] + capb;
        }
        std::vector<uint8_t> arena(soff[nb]);
        std::vector<int32_t> slen(nb, 0);
        for (int i = 0; i < nb; i++) {
            int gi = base + i;
            int r = htser::serialize_one(
                words + ms_off[gi], ms_nw[gi], ms_bits[gi],
                words + vlc_off[gi], vlc_nw[gi], vlc_bits[gi],
                words + mel_off[gi], mel_nw[gi], mel_bits[gi],
                numbps[gi], arena.data() + soff[i], soff[i + 1] - soff[i]);
            if (r < 0) { err.store(-(f + 1)); return; }
            slen[i] = r;
        }
        int64_t r = t2n::encode_frame(
            g, zbp + base, numbps + base,
            arena.data(), soff.data(), slen.data(),
            out + out_offsets[f], out_offsets[f + 1] - out_offsets[f]);
        if (r < 0) { err.store(-(f + 1)); return; }
        out_lens[f] = r;
    });
    return err.load();
}

// Fused T2 parse + HT block decode: per-frame packet data -> coefficients.
// coeffs laid out [n_frames * nb, cbh * cbw] (row-major per block).
int ht_t2_decode_frames(
    const uint8_t* data, const int64_t* frame_off,
    int32_t n_frames, int32_t nb,
    int32_t n_packets, const int32_t* pkt_nbp,
    const int32_t* bp_cbw, const int32_t* bp_cbh, const int32_t* bp_nblocks,
    const int32_t* bp_blocks, const int32_t* bp_block_xy,
    const int32_t* mb, const int32_t* ws, const int32_t* hs,
    int32_t cbh, int32_t cbw, int32_t* coeffs, int32_t n_threads)
{
    t2n::Geom g{n_packets, pkt_nbp, bp_cbw, bp_cbh, bp_nblocks, bp_blocks,
                bp_block_xy};
    g.finish();
    const int64_t cb_area = (int64_t)cbh * cbw;
    std::atomic<int> err{0};
    parallel_for(n_frames, n_threads, [&](int f) {
        int base = f * nb;
        std::vector<int32_t> nbps(nb, 0), blen(nb, 0);
        std::vector<int64_t> boff(nb, 0);
        std::vector<int32_t> tmp(cb_area);
        const uint8_t* d = data + frame_off[f];
        int64_t dlen = frame_off[f + 1] - frame_off[f];
        if (t2n::decode_frame(g, mb, d, dlen, nbps.data(), boff.data(),
                              blen.data()) < 0) {
            err.store(-(f + 1));
            return;
        }
        for (int i = 0; i < nb; i++) {
            // uniform padded [cbh, cbw] slots so the host can assemble
            // subbands with pure vectorized reshapes
            int32_t* out = coeffs + (int64_t)(base + i) * cb_area;
            std::memset(out, 0, sizeof(int32_t) * cb_area);
            if (nbps[i] <= 0) continue;
            int w = ws[i], h = hs[i];
            ht::ht_decode_one(d + boff[i], blen[i], w, h, nbps[i],
                              tmp.data());
            for (int y = 0; y < h; y++)
                std::memcpy(out + (int64_t)y * cbw, tmp.data() + (int64_t)y * w,
                            sizeof(int32_t) * w);
        }
    });
    return err.load();
}

// Fused T2 parse + HT VLC-phase parse (the host half of the DEVICE HT
// decode): per-frame packet data -> per-quad info words + unstuffed MagSgn
// word pool.  The per-sample MagSgn extraction, dequantization and inverse
// DWT run on device from these (ops/ht_tpu_decode.py).  Pool regions are
// per-frame: frame f's blocks pack sequentially into
// [pool_off[f], pool_off[f+1]) words (caller sizes each region to
// ceil(frame_bytes*8/32) + nb, a hard upper bound on unstuffed content).
int ht_t2_parse_frames(
    const uint8_t* data, const int64_t* frame_off,
    int32_t n_frames, int32_t nb,
    int32_t n_packets, const int32_t* pkt_nbp,
    const int32_t* bp_cbw, const int32_t* bp_cbh, const int32_t* bp_nblocks,
    const int32_t* bp_blocks, const int32_t* bp_block_xy,
    const int32_t* mb, const int32_t* ws, const int32_t* hs,
    int32_t cbh, int32_t cbw,
    uint32_t* qinfo, uint32_t* mag_pool, const int64_t* pool_off,
    int64_t* mag_woff, int32_t* mag_nw, int32_t* numbps_out,
    int32_t n_threads)
{
    t2n::Geom g{n_packets, pkt_nbp, bp_cbw, bp_cbh, bp_nblocks, bp_blocks,
                bp_block_xy};
    g.finish();
    const int qw_pad = (cbw + 1) / 2, qh_pad = (cbh + 1) / 2;
    const int64_t q_area = (int64_t)qw_pad * qh_pad;
    std::atomic<int> err{0};
    parallel_for(n_frames, n_threads, [&](int f) {
        int base = f * nb;
        std::vector<int32_t> nbps(nb, 0), blen(nb, 0);
        std::vector<int64_t> boff(nb, 0);
        const uint8_t* d = data + frame_off[f];
        int64_t dlen = frame_off[f + 1] - frame_off[f];
        if (t2n::decode_frame(g, mb, d, dlen, nbps.data(), boff.data(),
                              blen.data()) < 0) {
            err.store(-(f + 1));
            return;
        }
        int64_t wpos = pool_off[f];
        for (int i = 0; i < nb; i++) {
            int gi = base + i;
            numbps_out[gi] = nbps[i];
            uint32_t* qi = qinfo + (int64_t)gi * q_area;
            mag_woff[gi] = wpos;
            mag_nw[gi] = 0;
            if (nbps[i] <= 0) {
                std::memset(qi, 0, sizeof(uint32_t) * q_area);
                continue;
            }
            int64_t bits = 0;
            int nw = ht::ht_parse_one(
                d + boff[i], blen[i], ws[i], hs[i], nbps[i],
                qi, qw_pad, qh_pad,
                mag_pool + wpos, pool_off[f + 1] - wpos, &bits);
            if (nw < 0) { err.store(-(f + 1)); return; }
            mag_nw[gi] = nw;
            wpos += nw;
        }
    });
    return err.load();
}

} // extern "C"
