// fastscan: native hot loops for the cqs-tpu host runtime.
//
// Reference analog: the reference's ingest hot path is native end-to-end
// (tree-sitter C grammars + the Rust pipeline). Our TPU compute path is
// JAX/XLA; this library natively implements the host-side scans that
// dominate index builds:
//
//   - tokenize_hash: identifier-aware word splitting (camelCase/snake_case),
//     light suffix stemming, FNV-1a-64 hashing into a fixed vocab — the hash
//     tokenizer's inner loop, bit-identical to the Python fallback
//     (cqs_tpu/models/tokenizer.py).
//   - mask_source: string/comment masking for the parser engine — same
//     semantics as cqs_tpu/parser/generic.py::mask_source.
//
// Build: g++ -O3 -shared -fPIC -o libfastscan.so fastscan.cpp
// Loaded via ctypes (cqs_tpu/native/__init__.py); Python falls back to the
// pure implementation when the library is unavailable.

#include <cstdint>
#include <cstring>
#include <cctype>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// FNV-1a 64
// ---------------------------------------------------------------------------

static inline uint64_t fnv1a(const char* s, size_t n) {
    uint64_t h = 0xCBF29CE484222325ULL;
    for (size_t i = 0; i < n; i++) {
        h ^= (uint8_t)s[i];
        h *= 0x100000001B3ULL;
    }
    return h;
}

// ---------------------------------------------------------------------------
// Word stemming (mirrors HashTokenizer._stem)
// ---------------------------------------------------------------------------

static inline bool ends_with(const std::string& w, const char* suf) {
    size_t n = strlen(suf);
    return w.size() >= n && memcmp(w.data() + w.size() - n, suf, n) == 0;
}

static inline bool is_vowel(char c) {
    return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u';
}

static void stem(std::string& w) {
    struct Suf { const char* s; const char* repl; };
    static const Suf sufs[] = {
        {"ingly", ""}, {"edly", ""}, {"ing", ""}, {"ied", "y"},
        {"ies", "y"}, {"ed", ""}, {"es", ""}, {"s", ""},
    };
    for (const auto& suf : sufs) {
        size_t n = strlen(suf.s);
        if (ends_with(w, suf.s) && w.size() - n >= 3) {
            w.resize(w.size() - n);
            w += suf.repl;
            break;
        }
    }
    size_t n = w.size();
    if (n > 3 && w[n - 1] == w[n - 2] && !is_vowel(w[n - 1])) {
        w.resize(n - 1);
        n--;
    }
    if (n > 3 && w[n - 1] == 'e') w.resize(n - 1);
}

// ---------------------------------------------------------------------------
// tokenize_hash
// ---------------------------------------------------------------------------

static inline bool is_ident_char(char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_';
}
static inline bool is_alpha(char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}
static inline bool is_digit(char c) { return c >= '0' && c <= '9'; }
static inline bool is_upper(char c) { return c >= 'A' && c <= 'Z'; }
static inline bool is_lower(char c) { return c >= 'a' && c <= 'z'; }
static inline char to_lower(char c) { return is_upper(c) ? c + 32 : c; }

// Split one identifier into lowercase camel/snake words, stem each, hash each.
// Mirrors tokenize_identifier + _stem + _tok_id.
static void emit_ident(const char* s, size_t n, uint32_t vocab,
                       int32_t* out, int32_t max_out, int32_t* count) {
    size_t i = 0;
    while (i < n && *count < max_out) {
        // skip separators
        while (i < n && !is_alpha(s[i]) && !is_digit(s[i])) i++;
        if (i >= n) break;
        size_t start = i;
        if (is_digit(s[i])) {
            while (i < n && is_digit(s[i])) i++;
        } else if (is_upper(s[i])) {
            // acronym run: HTTPServer -> HTTP + Server
            size_t j = i + 1;
            while (j < n && is_upper(s[j])) j++;
            if (j < n && is_lower(s[j]) && j - i > 1) {
                i = j - 1;                     // acronym minus last cap
            } else {
                i = j;
                while (i < n && is_lower(s[i]) ) i++;   // Capitalized word
            }
        } else {
            while (i < n && is_lower(s[i])) i++;
        }
        // letter-led words absorb trailing digits ("arg0", "utf8", "HTTP2"),
        // matching the Python camel-split behavior
        if (!is_digit(s[start])) {
            while (i < n && is_digit(s[i])) i++;
        }
        if (i == start) { i++; continue; }
        std::string w(s + start, i - start);
        for (auto& c : w) c = to_lower(c);
        stem(w);
        if (w.empty()) continue;
        uint64_t h = fnv1a(w.data(), w.size());
        out[(*count)++] = (int32_t)(4 + h % (uint64_t)(vocab - 4));
    }
}

// text -> token ids. Returns count written (<= max_out).
int32_t tokenize_hash(const char* text, int64_t text_len, uint32_t vocab_size,
                      int32_t* out, int32_t max_out) {
    int32_t count = 0;
    int64_t i = 0;
    while (i < text_len && count < max_out) {
        char c = text[i];
        if (is_ident_char(c)) {
            int64_t start = i;
            while (i < text_len && is_ident_char(text[i])) i++;
            // pure number or identifier — split & hash
            emit_ident(text + start, i - start, vocab_size, out, max_out, &count);
        } else if ((unsigned char)c > ' ' && (unsigned char)c < 0x80) {
            // single punctuation token (lowercased byte)
            char w = to_lower(c);
            uint64_t h = fnv1a(&w, 1);
            out[count++] = (int32_t)(4 + h % (uint64_t)(vocab_size - 4));
            i++;
        } else {
            i++;
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// mask_source: blank string/comment contents in place (newlines preserved)
// ---------------------------------------------------------------------------

// config: line_comment (e.g. "//"), block_open ("/*"), block_close ("*/"),
// delims ("\"'`"), flags bit0 = single_quote_char_only,
// multiline_delims = delims whose literals span lines (rust ", go ` ...),
// raw_mark = leading char of raw strings (rust 'r' for r"..."/r#"..."#) or 0
void mask_source(char* text, int64_t n, const char* line_comment,
                 const char* block_open, const char* block_close,
                 const char* delims, int32_t flags,
                 const char* multiline_delims, int32_t raw_mark) {
    size_t lc_len = line_comment ? strlen(line_comment) : 0;
    size_t bo_len = block_open ? strlen(block_open) : 0;
    size_t bc_len = block_close ? strlen(block_close) : 0;
    bool sq_char_only = flags & 1;
    int64_t i = 0;
    while (i < n) {
        char c = text[i];
        if (c == '\n') { i++; continue; }
        if (lc_len && i + (int64_t)lc_len <= n && memcmp(text + i, line_comment, lc_len) == 0) {
            while (i < n && text[i] != '\n') { text[i] = ' '; i++; }
            continue;
        }
        if (bo_len && i + (int64_t)bo_len <= n && memcmp(text + i, block_open, bo_len) == 0) {
            int64_t j = i + bo_len;
            while (j + (int64_t)bc_len <= n && memcmp(text + j, block_close, bc_len) != 0) j++;
            int64_t end = (j + (int64_t)bc_len <= n) ? j + bc_len : n;
            for (int64_t k = i; k < end; k++)
                if (text[k] != '\n') text[k] = ' ';
            i = end;
            continue;
        }
        // raw string r"..." / r#"..."# (no escapes, spans lines)
        if (raw_mark && c == (char)raw_mark &&
            (i == 0 || !(isalnum((unsigned char)text[i-1]) || text[i-1] == '_'))) {
            int64_t j = i + 1;
            int hashes = 0;
            while (j < n && text[j] == '#') { hashes++; j++; }
            if (j < n && text[j] == '"') {
                int64_t p = j + 1;
                int64_t end = n;
                for (; p < n; p++) {
                    if (text[p] != '"') continue;
                    int h = 0;
                    while (p + 1 + h < n && h < hashes && text[p + 1 + h] == '#') h++;
                    if (h == hashes) { end = p + 1 + hashes; break; }
                }
                for (int64_t k = j + 1; k < end - 1 - hashes; k++)
                    if (text[k] != '\n') text[k] = ' ';
                i = end;
                continue;
            }
        }
        if (c == '\'' && sq_char_only) {
            // well-formed char literal only
            if (i + 2 < n && text[i + 1] == '\\' && i + 3 < n && text[i + 3] == '\'') {
                text[i + 1] = ' '; text[i + 2] = ' ';
                i += 4;
            } else if (i + 2 < n && text[i + 1] != '\'' && text[i + 1] != '\\' &&
                       text[i + 1] != '\n' && text[i + 2] == '\'') {
                text[i + 1] = ' ';
                i += 3;
            } else {
                i++;
            }
            continue;
        }
        if (strchr(delims, c) && c != '\0') {
            bool multiline = multiline_delims && strchr(multiline_delims, c) && c != '\0';
            int64_t j = i + 1;
            while (j < n) {
                if (text[j] == '\\' && c != '`') { j += 2; continue; }
                if (text[j] == c) { j++; break; }
                if (text[j] == '\n' && !multiline) { j++; break; }
                j++;
            }
            if (multiline) {
                // unterminated or absurdly long: fall back to single-line
                int64_t nl_count = 0;
                for (int64_t k = i; k < j && k < n; k++)
                    if (text[k] == '\n') nl_count++;
                if (j >= n || nl_count > 400) {
                    j = i;
                    while (j < n && text[j] != '\n') j++;
                    if (j < n) j++;
                }
            }
            int64_t end = (j < n) ? j : n;
            for (int64_t k = i + 1; k < end - 1; k++)
                if (text[k] != '\n') text[k] = ' ';
            i = end;
            continue;
        }
        i++;
    }
}

const char* fastscan_version() { return "2"; }

}  // extern "C"
