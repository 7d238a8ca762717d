// Short-read GAM emission in one pass: every record of a batch (one mate,
// or both mates of a paired batch interleaved with their mate-name and
// pair-annotation fields) written into one buffer by one call.
//
// Port-only. It does the work of the reference's emit_chosen_spans (the
// winner mismatch masks, the gapless-winner records of vgtpu_host.cpp's
// emit_gapless_gam with their refpos, unmapped records) and of its
// paired._finalize_pairs_native (fragment_next / fragment_prev and the
// annotation Struct), record bytes identical to theirs. The winners off
// the gapless path (indel, overhang and graph winners) arrive encoded, from
// the mapper's traceback, and are copied in place.
//
// Single-threaded and built without OpenMP: the pipeline's emitter threads
// give emit its parallelism, and the loader binds it with ctypes.CDLL, so
// each call runs without the Python interpreter lock.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline int64_t put_varint(uint8_t* out, int64_t pos, uint64_t v) {
    while (v >= 0x80) {
        out[pos++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    out[pos++] = (uint8_t)v;
    return pos;
}
inline int64_t put_tag(uint8_t* out, int64_t pos, uint32_t field,
                       uint32_t wt) {
    return put_varint(out, pos, (field << 3) | wt);
}

constexpr uint8_t SENTINEL = 6;   // ops/align.py: matches no read code

// utils/dna.py's codes: A C G T (either case) 0-3, anything else 4
struct Codes {
    uint8_t enc[256];
    Codes() {
        std::memset(enc, 4, sizeof(enc));
        enc[(unsigned)'A'] = enc[(unsigned)'a'] = 0;
        enc[(unsigned)'C'] = enc[(unsigned)'c'] = 1;
        enc[(unsigned)'G'] = enc[(unsigned)'g'] = 2;
        enc[(unsigned)'T'] = enc[(unsigned)'t'] = 3;
    }
};
const Codes CODES;

}  // namespace

extern "C" {

// What a record needs of one node, in one cache line's half: its id,
// length and the reference position of its first occurrence on a
// reference path (ref_path -1 off every path).
struct NodeRec {
    int64_t id, len, ref_off;
    int32_t ref_path;
    uint8_t ref_rev, pad[3];
};
static_assert(sizeof(NodeRec) == 32, "NodeRec is 32 bytes");

// The graph and haplotype tables every row reads (the mapper's; read only).
struct EmitGraph {
    const uint8_t* text;
    int64_t text_len;
    const int64_t* step_text_pos;     // (n_steps + 1,)
    const int64_t* steps;             // handles: node index << 1 | reverse
    int64_t n_steps;
    const NodeRec* nodes;
    // bucket_step[b]: the first step ending after text position
    // b << bucket_shift, for b = 0 .. (text_len >> bucket_shift) + 1
    const int64_t* bucket_step;
    int64_t bucket_shift;
    const int64_t* refname_off;       // the path names joined
    const uint8_t* refnames;
    int64_t match, mismatch, bonus;
};


// One mate's batch: R rows, the winner of each already chosen.
struct EmitMate {
    int64_t R;
    const int64_t* diag;              // winner's text position of read base 0
    const int32_t* lo;                // its haplotype's text range
    const int32_t* hi;
    const uint8_t* rev;
    const int32_t* best_s;
    const int32_t* mapq;
    const uint8_t* any_valid;
    const int64_t* best_j;
    // the device step's winner mismatches for candidate dev_j[i]: mode 0
    // none, 1 the first 8 positions (uint8 each), 2 a bitmap (bit c of
    // byte c / 8 for column c); pay_bytes per row
    int32_t pay_mode;
    const int64_t* dev_j;
    const int32_t* dev_mm;
    const uint8_t* pay;
    int64_t pay_bytes;
    const int64_t* name_off;          // (R + 1,) each a join of R strings
    const uint8_t* names;
    const int64_t* seq_off;           // ASCII bases, the read's own strand
    const uint8_t* seqs;
    const int64_t* qual_off;          // FASTQ quality bytes (phred + 33)
    const uint8_t* quals;
    // rows encoded elsewhere: ext[ext_off[i] : ext_off[i] + ext_len[i]]
    const int64_t* ext_off;
    const int64_t* ext_len;
    const uint8_t* ext;
    // emit_classify's output: 0 unmapped, 1 gapless winner, 2 encoded
    // elsewhere (ext)
    uint8_t* kind;
    int32_t* mm;
};

}  // extern "C"

namespace {


// The first step ending after text position t (numpy's
// searchsorted(step_text_pos[1:], t, "right")), searched inside t's
// bucket only.
inline int64_t step_of(const EmitGraph& g, int64_t t) {
    int64_t lo = 0, hi = g.n_steps;
    if (t >= 0 && t < g.text_len) {
        const int64_t b = t >> g.bucket_shift;
        lo = g.bucket_step[b];
        hi = g.bucket_step[b + 1];
    }
    while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (g.step_text_pos[mid + 1] > t) hi = mid; else lo = mid + 1;
    }
    return lo;
}

inline int64_t read_len(const EmitMate& m, int64_t i) {
    return m.seq_off[i + 1] - m.seq_off[i];
}

inline bool use_device(const EmitMate& m, int64_t i) {
    return m.pay_mode != 0 && m.best_j[i] == m.dev_j[i]
        && (m.pay_mode != 1 || m.dev_mm[i] <= 8);
}

// Row i's oriented-read mismatch mask against the text, columns [0, L).
void text_mask(const EmitGraph& g, const EmitMate& m, int64_t i,
               uint8_t* mask) {
    const int64_t L = read_len(m, i);
    const uint8_t* s = m.seqs + m.seq_off[i];
    const bool rv = m.rev[i] != 0;
    const int64_t d = m.diag[i], lo = m.lo[i], hi = m.hi[i];
    for (int64_t c = 0; c < L; c++) {
        uint8_t o = CODES.enc[s[rv ? L - 1 - c : c]];
        if (rv && o < 4) o = (uint8_t)(3 - o);
        const int64_t p = d + c;
        const uint8_t t = (p >= lo && p < hi && p >= 0 && p < g.text_len)
            ? g.text[p] : SENTINEL;
        mask[c] = (uint8_t)(t != o || o >= 4);
    }
}

// Row i's mask from the device payload (columns < RL, as the payload
// gives them).
void device_mask(const EmitMate& m, int64_t i, int64_t RL, uint8_t* mask) {
    std::memset(mask, 0, (size_t)RL);
    const uint8_t* p = m.pay + i * m.pay_bytes;
    if (m.pay_mode == 1) {
        for (int32_t k = 0; k < m.dev_mm[i] && k < 8 && RL > 0; k++)
            mask[p[k] < RL ? p[k] : RL - 1] = 1;
    } else {
        for (int64_t c = 0; c < RL; c++)
            mask[c] = (p[c >> 3] >> (c & 7)) & 1;
    }
}

int64_t batch_rl(const EmitMate& m) {
    int64_t RL = 0;
    for (int64_t i = 0; i < m.R; i++)
        if (read_len(m, i) > RL) RL = read_len(m, i);
    return RL;
}

inline int varint_size(uint64_t v) {
    int n = 1;
    while (v >= 0x80) { v >>= 7; n++; }
    return n;
}

struct Scratch {
    std::vector<uint8_t> mask, path, map, tmp;
    int64_t path_len = 0;
    int64_t first_step = 0, last_step = -1;   // of the last path built
};

// A gapless winner's path (emit_gapless_gam's mappings), into
// s.path[0, s.path_len): each mapping's body written once into s.map,
// then behind its tag and length into s.path.
void gapless_path(const EmitGraph& g, const EmitMate& m, int64_t i,
                  const uint8_t* mrow, Scratch& s) {
    const int64_t L = read_len(m, i);
    const int64_t t0 = m.diag[i], t1 = t0 + L;
    const bool rev = m.rev[i] != 0;
    const uint8_t* rd = m.seqs + m.seq_off[i];
    const int64_t lo = step_of(g, t0);
    int64_t n_pieces = 0;
    for (int64_t cur = t0, si = lo; cur < t1; si++) {
        cur = std::min(t1, g.step_text_pos[si + 1]);
        n_pieces++;
    }
    // a mapping: at most 40 bytes besides its edits; an edit at most 37
    // besides its bases
    const size_t bound = (size_t)(48 * n_pieces + 38 * L + L + 16);
    if (s.path.size() < bound) s.path.resize(2 * bound);
    if (s.map.size() < bound) s.map.resize(2 * bound);
    uint8_t* out = s.path.data();
    int64_t op = 0;
    for (int64_t pi = 0; pi < n_pieces; pi++) {
        // piece k of the forward walk: step lo + k over text
        // [max(t0, stp[lo + k]), min(t1, stp[lo + k + 1]))
        const int64_t k = rev ? n_pieces - 1 - pi : pi;
        const int64_t si = lo + k;
        const int64_t a = std::max(t0, g.step_text_pos[si]);
        const int64_t b = std::min(t1, g.step_text_pos[si + 1]);
        const int64_t h = g.steps[si];
        int64_t off = a - g.step_text_pos[si], len = b - a;
        const NodeRec& nd = g.nodes[h >> 1];
        const int64_t nid = nd.id, nlen = nd.len;
        bool mrev = (h & 1) != 0;
        if (rev) { mrev = !mrev; off = nlen - off - len; }
        // this piece's interval of the read as emitted
        const int64_t fs0 = a - t0;
        const int64_t fs = rev ? (L - fs0 - len) : fs0;
        uint8_t* mb = s.map.data();
        int64_t mp = 2;            // the position's tag and length
        mp = put_tag(mb, mp, 1, 0);
        mp = put_varint(mb, mp, (uint64_t)nid);
        if (off) {
            mp = put_tag(mb, mp, 2, 0);
            mp = put_varint(mb, mp, (uint64_t)off);
        }
        if (mrev) {
            mp = put_tag(mb, mp, 4, 0);
            mb[mp++] = 1;
        }
        mb[0] = (1 << 3) | 2;
        mb[1] = (uint8_t)(mp - 2);  // at most 24 bytes
        // edits: runs of matches and mismatches over [fs, fs + len); the
        // mask is in oriented space, emitted column j is oriented L-1-j
        // on the reverse strand
        auto mis_at = [&](int64_t j) -> bool {
            return mrow[rev ? (L - 1 - j) : j] != 0;
        };
        const int64_t fe = fs + len;
        for (int64_t e = fs; e < fe;) {
            const bool state = mis_at(e);
            int64_t run_end = e + 1;
            while (run_end < fe && mis_at(run_end) == state) run_end++;
            const uint64_t n = (uint64_t)(run_end - e);
            const int vn = varint_size(n);
            const uint64_t elen = 2 * (1 + vn) + (state ? 1 + vn + n : 0);
            mp = put_tag(mb, mp, 2, 2);
            mp = put_varint(mb, mp, elen);
            mp = put_tag(mb, mp, 1, 0);
            mp = put_varint(mb, mp, n);
            mp = put_tag(mb, mp, 2, 0);
            mp = put_varint(mb, mp, n);
            if (state) {
                mp = put_tag(mb, mp, 3, 2);
                mp = put_varint(mb, mp, n);
                std::memcpy(mb + mp, rd + e, (size_t)n);
                mp += (int64_t)n;
            }
            e = run_end;
        }
        mp = put_tag(mb, mp, 5, 0);               // rank
        mp = put_varint(mb, mp, (uint64_t)(pi + 1));
        op = put_tag(out, op, 2, 2);
        op = put_varint(out, op, (uint64_t)mp);
        std::memcpy(out + op, mb, (size_t)mp);
        op += mp;
    }
    s.path_len = op;
    s.first_step = lo;
    s.last_step = lo + n_pieces - 1;
}

// The refpos of a gapless winner's first mapping (the node at t0, or at
// t1 - 1 on the reverse strand: the first or the last step of the path
// gapless_path just built), into s.tmp; empty off every path. False
// where the winner lies past the last step.
bool gapless_refpos(const EmitGraph& g, const EmitMate& m, int64_t i,
                    Scratch& s) {
    const int64_t L = read_len(m, i);
    const int64_t t0 = m.diag[i], t1 = t0 + L;
    const bool rev = m.rev[i] != 0;
    const int64_t si = !rev ? s.first_step
                            : L ? s.last_step : step_of(g, t1 - 1);
    if (si >= g.n_steps) return false;
    const int64_t h = g.steps[si];
    const NodeRec& nd = g.nodes[h >> 1];
    const int64_t nlen = nd.len;
    const int64_t moff = rev ? nlen - (t1 - g.step_text_pos[si])
                             : t0 - g.step_text_pos[si];
    const bool mrev = ((h & 1) != 0) != rev;
    s.tmp.clear();
    const int32_t rp = nd.ref_path;
    if (rp < 0) return true;
    const bool same = mrev == (nd.ref_rev != 0);
    const int64_t roff = nd.ref_off + (same ? moff : nlen - moff);
    const int64_t rn0 = g.refname_off[rp], rn1 = g.refname_off[rp + 1];
    s.tmp.resize(32 + (rn1 - rn0));
    uint8_t* t = s.tmp.data();
    int64_t p = 0;
    if (roff) {
        p = put_tag(t, p, 2, 0);
        p = put_varint(t, p, (uint64_t)roff);
    }
    if (!same) {
        p = put_tag(t, p, 4, 0);
        t[p++] = 1;
    }
    p = put_tag(t, p, 5, 2);
    p = put_varint(t, p, (uint64_t)(rn1 - rn0));
    std::memcpy(t + p, g.refnames + rn0, (size_t)(rn1 - rn0));
    s.tmp.resize(p + (rn1 - rn0));
    return true;
}

// Writers below return the new position, or -1 where out_cap is short.

int64_t put_bytes(uint8_t* out, int64_t pos, int64_t cap, uint32_t field,
                  const uint8_t* b, int64_t n) {
    if (pos + n + 12 > cap) return -1;
    pos = put_tag(out, pos, field, 2);
    pos = put_varint(out, pos, (uint64_t)n);
    std::memcpy(out + pos, b, (size_t)n);
    return pos + n;
}

int64_t put_quality(uint8_t* out, int64_t pos, int64_t cap,
                    const EmitMate& m, int64_t i) {
    const int64_t n = m.qual_off[i + 1] - m.qual_off[i];
    if (!n) return pos;
    if (pos + n + 12 > cap) return -1;
    pos = put_tag(out, pos, 4, 2);
    pos = put_varint(out, pos, (uint64_t)n);
    const uint8_t* q = m.quals + m.qual_off[i];
    for (int64_t k = 0; k < n; k++) out[pos + k] = (uint8_t)(q[k] - 33);
    return pos + n;
}

// A gapless winner's Alignment (emit_gapless_gam's field order).
int64_t put_gapless(const EmitGraph& g, const EmitMate& m, int64_t i,
                    int64_t RL, uint8_t* out, int64_t pos, int64_t cap,
                    Scratch& s) {
    const int64_t L = read_len(m, i);
    uint8_t* mrow = s.mask.data();
    if (use_device(m, i)) device_mask(m, i, RL, mrow);
    else text_mask(g, m, i, mrow);
    gapless_path(g, m, i, mrow, s);
    if (!gapless_refpos(g, m, i, s)) return -2;
    const int64_t name_len = m.name_off[i + 1] - m.name_off[i];
    const int64_t qual_len = m.qual_off[i + 1] - m.qual_off[i];
    // the fields' bytes and at most 96 of tags, lengths and numbers
    if (pos + L + s.path_len + name_len + qual_len
            + (int64_t)s.tmp.size() + 96 > cap) return -1;
    pos = put_bytes(out, pos, cap, 1, m.seqs + m.seq_off[i], L);
    pos = put_bytes(out, pos, cap, 2, s.path.data(), s.path_len);
    if (name_len)
        pos = put_bytes(out, pos, cap, 3, m.names + m.name_off[i], name_len);
    pos = put_quality(out, pos, cap, m, i);
    if (pos < 0) return -1;
    if (m.mapq[i]) {
        pos = put_tag(out, pos, 5, 0);
        pos = put_varint(out, pos, (uint64_t)m.mapq[i]);
    }
    if (m.best_s[i]) {
        pos = put_tag(out, pos, 6, 0);
        pos = put_varint(out, pos, (uint64_t)m.best_s[i]);
    }
    int64_t mmc = 0;
    for (int64_t q = 0; q < L; q++) mmc += mrow[q] ? 1 : 0;
    const double ident = L ? (double)(L - mmc) / (double)L : 0.0;
    pos = put_tag(out, pos, 16, 1);
    std::memcpy(out + pos, &ident, 8);
    pos += 8;
    if (!s.tmp.empty())
        pos = put_bytes(out, pos, cap, 19, s.tmp.data(),
                        (int64_t)s.tmp.size());
    return pos;
}

// An unmapped read's Alignment: sequence, name, quality (each if any).
int64_t put_unmapped(const EmitMate& m, int64_t i, uint8_t* out,
                     int64_t pos, int64_t cap) {
    const int64_t L = read_len(m, i);
    const int64_t name_len = m.name_off[i + 1] - m.name_off[i];
    if (L) pos = put_bytes(out, pos, cap, 1, m.seqs + m.seq_off[i], L);
    if (pos >= 0 && name_len)
        pos = put_bytes(out, pos, cap, 3, m.names + m.name_off[i], name_len);
    return pos < 0 ? -1 : put_quality(out, pos, cap, m, i);
}

int64_t put_row(const EmitGraph& g, const EmitMate& m, int64_t i,
                int64_t RL, uint8_t* out, int64_t pos, int64_t cap,
                Scratch& s) {
    switch (m.kind[i]) {
    case 0:
        return put_unmapped(m, i, out, pos, cap);
    case 1:
        return put_gapless(g, m, i, RL, out, pos, cap, s);
    default: {
        const int64_t n = m.ext_len[i];
        if (n < 0) return -2;
        if (pos + n > cap) return -1;
        std::memcpy(out + pos, m.ext + m.ext_off[i], (size_t)n);
        return pos + n;
    }
    }
}

// fragment_next (12) or fragment_prev (11): an Alignment holding the
// mate's name
// fragment_next (12) or fragment_prev (11): an Alignment holding the
// mate's name
int64_t put_mate_name(const EmitMate& mate, int64_t i, uint32_t field,
                      uint8_t* out, int64_t pos, int64_t cap) {
    const int64_t n = mate.name_off[i + 1] - mate.name_off[i];
    const int64_t inner = 1 + varint_size((uint64_t)n) + n;
    if (pos + inner + 12 > cap) return -1;
    pos = put_tag(out, pos, field, 2);
    pos = put_varint(out, pos, (uint64_t)inner);
    pos = put_tag(out, pos, 3, 2);
    pos = put_varint(out, pos, (uint64_t)n);
    std::memcpy(out + pos, mate.names + mate.name_off[i], (size_t)n);
    return pos + n;
}

// annotation (100): Struct {proper_pair: bool[, fragment_length: double]},
// the fragment length left out where it is 0 (io/gam._encode_struct)
int64_t put_annotation(bool proper, int64_t frag, uint8_t* out, int64_t pos,
                       int64_t cap) {
    static const char PP[] = "proper_pair";
    static const char FL[] = "fragment_length";
    uint8_t st[64];
    int64_t p = 0;
    st[p++] = (1 << 3) | 2;                    // fields entry
    st[p++] = 2 + 11 + 4;
    st[p++] = (1 << 3) | 2;                    // key
    st[p++] = 11;
    std::memcpy(st + p, PP, 11);
    p += 11;
    st[p++] = (2 << 3) | 2;                    // value: bool_value (4)
    st[p++] = 2;
    st[p++] = (4 << 3) | 0;
    st[p++] = proper ? 1 : 0;
    if (frag) {
        st[p++] = (1 << 3) | 2;
        st[p++] = 2 + 15 + 11;
        st[p++] = (1 << 3) | 2;
        st[p++] = 15;
        std::memcpy(st + p, FL, 15);
        p += 15;
        st[p++] = (2 << 3) | 2;                // value: number_value (2)
        st[p++] = 9;
        st[p++] = (2 << 3) | 1;
        const double v = (double)frag;
        std::memcpy(st + p, &v, 8);
        p += 8;
    }
    return put_bytes(out, pos, cap, 100, st, p);
}

}  // namespace

extern "C" {

// Each row's kind and mismatch count (EmitMate.kind, .mm): unmapped (no
// valid candidate), gapless (its gapless score is the DP's best and its
// window lies inside its haplotype), or off that path, to be encoded
// elsewhere. The mismatch count is the device's where its payload covers
// the row, else counted on the text. Returns the number of gapless rows,
// or -2 where a read's sequence is not ASCII.
int64_t emit_classify(const EmitGraph* gp, EmitMate* mp) {
    const EmitGraph& g = *gp;
    EmitMate& m = *mp;
    const int64_t RL = batch_rl(m);
    if (m.pay_mode == 2 && m.pay_bytes * 8 < RL) m.pay_mode = 0;
    for (int64_t i = 0; i < m.seq_off[m.R] - m.seq_off[0]; i++)
        if (m.seqs[m.seq_off[0] + i] >= 0x80) return -2;
    std::vector<uint8_t> mask((size_t)RL + 1);
    int64_t n_fast = 0;
    for (int64_t i = 0; i < m.R; i++) {
        if (!m.any_valid[i]) {
            m.kind[i] = 0;
            m.mm[i] = 0;
            continue;
        }
        const int64_t L = read_len(m, i);
        int64_t mm = 0;
        if (use_device(m, i)) {
            mm = m.dev_mm[i];
        } else {
            text_mask(g, m, i, mask.data());
            for (int64_t c = 0; c < L; c++) mm += mask[c];
        }
        const int64_t gl = (L - mm) * g.match - mm * g.mismatch
            + 2 * g.bonus;
        const bool fast = gl == m.best_s[i] && m.diag[i] >= m.lo[i]
            && m.diag[i] + L <= m.hi[i];
        m.kind[i] = fast ? 1 : 2;
        m.mm[i] = (int32_t)mm;
        n_fast += fast;
    }
    return n_fast;
}

// Every record of the batch into out, rec_off[k] its start (rec_off[n]
// the end). Without m2: m1's R records in row order. With m2 (a paired
// batch, R rows each): records interleaved m1[i], m2[i], m1's carrying
// fragment_next (m2's name) and m2's fragment_prev (m1's name), both
// then the pair's annotation: proper with its fragment length where
// use_pair[i], improper where either mate is mapped, none else. Returns
// the bytes written, -1 where out_cap is short, -2 where a row cannot be
// written (a row of kind 2 without bytes, a winner past the last step).
int64_t emit_records(const EmitGraph* gp, const EmitMate* m1,
                     const EmitMate* m2, const uint8_t* use_pair,
                     const int64_t* frags, uint8_t* out, int64_t out_cap,
                     int64_t* rec_off) {
    const EmitGraph& g = *gp;
    const int64_t R = m1->R;
    if (m2 && m2->R != R) return -2;
    // each mate's own widest read: the device payload's columns are its
    const int64_t RL1 = batch_rl(*m1), RL2 = m2 ? batch_rl(*m2) : 0;
    Scratch s;
    s.mask.resize((size_t)std::max(RL1, RL2) + 1);
    int64_t pos = 0, k = 0;
    for (int64_t i = 0; i < R; i++) {
        for (int mate = 0; mate < (m2 ? 2 : 1); mate++) {
            const EmitMate& m = mate ? *m2 : *m1;
            rec_off[k++] = pos;
            pos = put_row(g, m, i, mate ? RL2 : RL1, out, pos, out_cap, s);
            if (pos >= 0 && m2) {
                pos = put_mate_name(mate ? *m1 : *m2, i, mate ? 11 : 12,
                                    out, pos, out_cap);
                if (pos >= 0 && use_pair[i])
                    pos = put_annotation(true, frags[i], out, pos, out_cap);
                else if (pos >= 0 && (m1->any_valid[i] || m2->any_valid[i]))
                    pos = put_annotation(false, 0, out, pos, out_cap);
            }
            if (pos < 0) return pos;
        }
    }
    rec_off[k] = pos;
    return pos;
}

}  // extern "C"
