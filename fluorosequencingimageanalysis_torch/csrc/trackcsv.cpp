// trackcsv: native parser for track-photometries CSVs.
//
// The experiment layer emits track CSVs with schema
// CHANNEL,FIELD,H,W,CATEGORY,FRAME i... (flexlibrary.py:2858-2866) and the
// inference layer re-ingests them row by row in Python
// (MCsimlib.py:2534-2575) — float parsing and category tokenizing dominate
// for 10^4-10^5 tracks. This parser does one pass in C++ and exposes flat
// arrays over a plain C ABI (ctypes binding; no CPython API).
//
// Semantics matched to inference/photometries.py:read_track_photometries_csv:
//  - row index counts ALL csv records including the header and skipped rows;
//  - rows with H or W == "None" are skipped;
//  - FIELD/H/W and frame values parsed as llround(strtod(...)), with
//    full-token validation (malformed cells abort to the Python
//    fallback, which raises like the reference);
//  - CATEGORY is "(True, False, ...)": strip outer parens, split on ' ',
//    token is ON iff it equals "True" or "True,";
//  - head/tail truncation applied to categories and frames;
//  - downstep filter keeps rows whose category is monotonically
//    non-increasing AND starts True.
// Ragged frame counts abort the parse (caller falls back to Python).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct TrackCsv {
  int64_t n_rows = 0;
  int32_t n_frames = 0;
  std::string channel_blob;            // '\n'-joined per-row channel names
  std::vector<int32_t> fields;
  std::vector<int32_t> hs;
  std::vector<int32_t> ws;
  std::vector<int64_t> rows;           // original csv record index
  std::vector<uint8_t> cats;           // n_rows * n_frames
  std::vector<int64_t> frames;         // n_rows * n_frames
};

// Split one CSV record (RFC-4180-ish: double quotes, embedded commas).
void split_csv(const std::string& line, std::vector<std::string>* out) {
  out->clear();
  std::string cur;
  bool in_quotes = false;
  for (size_t i = 0; i < line.size(); ++i) {
    char c = line[i];
    if (in_quotes) {
      if (c == '"') {
        if (i + 1 < line.size() && line[i + 1] == '"') {
          cur.push_back('"');
          ++i;
        } else {
          in_quotes = false;
        }
      } else {
        cur.push_back(c);
      }
    } else if (c == '"') {
      in_quotes = true;
    } else if (c == ',') {
      out->push_back(cur);
      cur.clear();
    } else if (c != '\r') {
      cur.push_back(c);
    }
  }
  out->push_back(cur);
}

// Strict llround(strtod): the WHOLE token (minus trailing blanks) must
// parse to a finite double, else the row is malformed and the parse
// aborts so the caller falls back to the Python reader — which raises
// ValueError on the same cell. Silent prefixes ("12a45" -> 12), empty
// cells (-> 0) and NaN (llround UB) must not become quiet wrong data.
bool round_ll(const std::string& s, int64_t* out_v) {
  // strtod is LOOSER than Python float(): it accepts hex floats
  // ("0x10" -> 16) and "nan(chars)" payload spellings that float()
  // rejects with ValueError. Reject those outright so such cells abort
  // to the Python reader instead of becoming quiet wrong data.
  for (char ch : s)
    if (ch == 'x' || ch == 'X' || ch == '(' || ch == ')') return false;
  const char* p = s.c_str();
  char* end = nullptr;
  double v = strtod(p, &end);
  if (end == p || !std::isfinite(v)) return false;
  while (*end == ' ' || *end == '\t') ++end;
  if (*end != '\0') return false;
  *out_v = llround(v);
  return true;
}

}  // namespace

extern "C" {

void* tcsv_parse(const char* path, int32_t head_truncate,
                 int32_t tail_truncate, int32_t downstep_filtered,
                 int32_t omit_header) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* out = new TrackCsv();
  std::string line;
  std::vector<std::string> cols;
  std::vector<uint8_t> cat;
  std::vector<int64_t> fr;
  int64_t r = -1;
  int c = 0;
  line.reserve(4096);
  bool ok = true;
  while (ok) {
    line.clear();
    while ((c = fgetc(f)) != EOF && c != '\n') line.push_back((char)c);
    if (line.empty() && c == EOF) break;
    ++r;
    if (r == 0 && omit_header) continue;
    split_csv(line, &cols);
    if (cols.size() < 6) {
      // Blank lines and short rows are NOT skippable: the Python reader
      // raises on a blank line (like the reference's unpack), and a
      // 5-column file (zero frame columns) is VALID there (empty frame
      // tuples). Either way this parser cannot reproduce the behavior,
      // so abort and let the caller fall back to the Python path.
      ok = false;
      break;
    }
    const std::string& h_s = cols[2];
    const std::string& w_s = cols[3];
    if (h_s == "None" || w_s == "None") continue;
    // category: "(True, False, ...)" -> strip parens, split on ' '.
    const std::string& cs = cols[4];
    cat.clear();
    {
      std::string body = cs.size() >= 2 ? cs.substr(1, cs.size() - 2) : "";
      size_t pos = 0;
      while (pos <= body.size()) {
        size_t sp = body.find(' ', pos);
        std::string tok = body.substr(
            pos, sp == std::string::npos ? std::string::npos : sp - pos);
        cat.push_back(tok == "True" || tok == "True," ? 1 : 0);
        if (sp == std::string::npos) break;
        pos = sp + 1;
      }
    }
    fr.clear();
    {
      int64_t v;
      for (size_t i = 5; i < cols.size(); ++i) {
        if (!round_ll(cols[i], &v)) { ok = false; break; }
        fr.push_back(v);
      }
      if (!ok) break;
    }
    // truncation (python slice semantics on both)
    auto truncate = [&](auto& v) {
      int64_t lo = head_truncate;
      int64_t hi = (int64_t)v.size() - (tail_truncate > 0 ? tail_truncate : 0);
      if (lo < 0) lo = 0;
      if (hi < lo) hi = lo;
      if (hi > (int64_t)v.size()) hi = v.size();
      v.erase(v.begin() + hi, v.end());
      v.erase(v.begin(), v.begin() + (lo < (int64_t)v.size() ? lo : v.size()));
    };
    truncate(cat);
    truncate(fr);
    if (downstep_filtered) {
      if (cat.empty()) {
        // The Python reader evaluates parsed_cat[0] here and raises
        // IndexError (truncation ate every category token); silently
        // filtering the row would hide that. Abort to the fallback.
        ok = false;
        break;
      }
      bool monotone = true;
      for (size_t i = 1; i < cat.size(); ++i)
        if (cat[i] > cat[i - 1]) { monotone = false; break; }
      if (!(monotone && cat[0])) continue;
    }
    if (out->n_rows == 0) {
      out->n_frames = (int32_t)fr.size();
    } else if ((int32_t)fr.size() != out->n_frames ||
               (int32_t)cat.size() != out->n_frames) {
      ok = false;  // ragged: bail, caller falls back to Python
      break;
    }
    if ((int32_t)cat.size() != out->n_frames) { ok = false; break; }
    int64_t fld_v, h_v, w_v;
    if (!round_ll(cols[1], &fld_v) || !round_ll(h_s, &h_v) ||
        !round_ll(w_s, &w_v)) {
      ok = false;
      break;
    }
    if (out->n_rows > 0) out->channel_blob.push_back('\n');
    out->channel_blob += cols[0];
    out->fields.push_back((int32_t)fld_v);
    out->hs.push_back((int32_t)h_v);
    out->ws.push_back((int32_t)w_v);
    out->rows.push_back(r);
    out->cats.insert(out->cats.end(), cat.begin(), cat.end());
    out->frames.insert(out->frames.end(), fr.begin(), fr.end());
    out->n_rows += 1;
    if (c == EOF) break;
  }
  fclose(f);
  if (!ok) {
    delete out;
    return nullptr;
  }
  return out;
}

int64_t tcsv_n_rows(void* h) { return ((TrackCsv*)h)->n_rows; }
int32_t tcsv_n_frames(void* h) { return ((TrackCsv*)h)->n_frames; }
const char* tcsv_channels(void* h) {
  return ((TrackCsv*)h)->channel_blob.c_str();
}
const int32_t* tcsv_fields(void* h) { return ((TrackCsv*)h)->fields.data(); }
const int32_t* tcsv_hs(void* h) { return ((TrackCsv*)h)->hs.data(); }
const int32_t* tcsv_ws(void* h) { return ((TrackCsv*)h)->ws.data(); }
const int64_t* tcsv_rows(void* h) { return ((TrackCsv*)h)->rows.data(); }
const uint8_t* tcsv_cats(void* h) { return ((TrackCsv*)h)->cats.data(); }
const int64_t* tcsv_frames(void* h) { return ((TrackCsv*)h)->frames.data(); }
void tcsv_free(void* h) { delete (TrackCsv*)h; }

}  // extern "C"
