// The interaction reader of the port's data loader: a TSV with a header
// parsed as Python's csv.reader(delimiter='\t') parses it, the (user,
// item) string pairs of two named columns sorted, and dense ids assigned in
// order of first appearance, in one pass over the file's bytes.
//
// Host code, built with the host C++ compiler at first use
// (textgcn_tpu_torch/native.py); the card is not involved.  The semantics
// are those of the plain reader, data/core.py's _read_interactions:
//
//   * the bytes must be UTF-8 (Python's strict decoder: no overlong
//     forms, no surrogates, nothing above U+10FFFF);
//   * records are cut as csv.reader cuts them from a file opened with
//     newline='': a line ends after '\n', '\r\n' or a lone '\r'; a field
//     that starts with '"' is quoted and may hold tabs, line breaks and
//     doubled quotes; characters after a closing quote are kept (the
//     dialect is not strict); an unterminated quote runs to the end of
//     the file; a field longer than the field limit (in code points) is
//     an error;
//   * the first record is the header; the columns are found by name (the
//     first of each), extra columns are allowed;
//   * an empty record (a blank line) is skipped; any other record must
//     have as many fields as the header;
//   * the pairs are sorted by (user, item) in byte order, which is the
//     code-point order of Python's string comparison, and ids follow the
//     first appearance in the sorted rows.
//
// Errors stop the parse and are reported by a status code with the record
// number (the header is record 1); the Python side words the message.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

enum Status : int32_t {
  kOk = 0,
  kNotUtf8 = 1,
  kFieldCount = 2,
  kMissingColumn = 3,
  kEmpty = 4,
  kFieldLimit = 5,
};

struct Parsed {
  int32_t status = kOk;
  int64_t line = 0;      // the record (or, for kNotUtf8, the line) at fault
  int64_t expected = 0;  // kFieldCount: the header's fields
  int64_t got = 0;       // kFieldCount: the record's fields
  std::vector<std::string> header;
  std::vector<int32_t> user, item;     // dense ids, sorted row order
  std::vector<std::string> user_ids;   // dense id -> external id
  std::vector<std::string> item_ids;
};

// The offset of the first byte that Python's strict UTF-8 decoder
// rejects (the start of the bad sequence), or -1.
int64_t first_invalid_utf8(const unsigned char* s, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    unsigned char c = s[i];
    if (c < 0x80) {
      ++i;
      continue;
    }
    int need;
    unsigned char lo = 0x80, hi = 0xBF;
    if (c >= 0xC2 && c <= 0xDF) {
      need = 1;
    } else if (c >= 0xE0 && c <= 0xEF) {
      need = 2;
      if (c == 0xE0) lo = 0xA0;
      if (c == 0xED) hi = 0x9F;
    } else if (c >= 0xF0 && c <= 0xF4) {
      need = 3;
      if (c == 0xF0) lo = 0x90;
      if (c == 0xF4) hi = 0x8F;
    } else {
      return i;
    }
    if (i + need >= n) return i;  // cut short by the end of the data
    if (s[i + 1] < lo || s[i + 1] > hi) return i;
    for (int k = 2; k <= need; ++k) {
      if (s[i + k] < 0x80 || s[i + k] > 0xBF) return i;
    }
    i += need + 1;
  }
  return -1;
}

// csv.reader's states for the default dialect with delimiter '\t'
enum State {
  START_RECORD,
  START_FIELD,
  IN_FIELD,
  IN_QUOTED_FIELD,
  QUOTE_IN_QUOTED_FIELD,
  EAT_CRNL,
};

struct Reader {
  const char* buf = nullptr;
  int64_t len = 0;
  int64_t pos = 0;
  int64_t field_limit = 0;
  State state = START_RECORD;
  std::string field;
  int64_t field_chars = 0;
  std::vector<std::string> fields;
  bool over_limit = false;

  void save_field() {
    fields.push_back(std::move(field));
    field.clear();
    field_chars = 0;
  }

  void add_char(char c) {
    // code points: every byte that is not a continuation byte
    if ((static_cast<unsigned char>(c) & 0xC0) != 0x80) {
      if (field_chars >= field_limit) {
        over_limit = true;
        return;
      }
      ++field_chars;
    }
    field.push_back(c);
  }

  // One character; eol marks the end of a line (csv.reader's EOL).
  void process(char c, bool eol) {
    switch (state) {
      case START_RECORD:
        if (eol) break;
        if (c == '\n' || c == '\r') {
          state = EAT_CRNL;
          break;
        }
        state = START_FIELD;
        [[fallthrough]];
      case START_FIELD:
        if (eol || c == '\n' || c == '\r') {
          save_field();
          state = eol ? START_RECORD : EAT_CRNL;
        } else if (c == '"') {
          state = IN_QUOTED_FIELD;
        } else if (c == '\t') {
          save_field();
        } else {
          add_char(c);
          state = IN_FIELD;
        }
        break;
      case IN_FIELD:
        if (eol || c == '\n' || c == '\r') {
          save_field();
          state = eol ? START_RECORD : EAT_CRNL;
        } else if (c == '\t') {
          save_field();
          state = START_FIELD;
        } else {
          add_char(c);
        }
        break;
      case IN_QUOTED_FIELD:
        if (eol) {
        } else if (c == '"') {
          state = QUOTE_IN_QUOTED_FIELD;
        } else {
          add_char(c);
        }
        break;
      case QUOTE_IN_QUOTED_FIELD:
        if (!eol && c == '"') {
          add_char(c);
          state = IN_QUOTED_FIELD;
        } else if (!eol && c == '\t') {
          save_field();
          state = START_FIELD;
        } else if (eol || c == '\n' || c == '\r') {
          save_field();
          state = eol ? START_RECORD : EAT_CRNL;
        } else {
          add_char(c);
          state = IN_FIELD;
        }
        break;
      case EAT_CRNL:
        // a line ends at its line break, so nothing but EOL follows one
        if (eol) state = START_RECORD;
        break;
    }
  }

  // The next record, its fields in `fields`; false at the end of the
  // input or when a field went over the limit (see over_limit).
  bool next() {
    fields.clear();
    field.clear();
    field_chars = 0;
    state = START_RECORD;
    do {
      if (pos >= len) {
        // end of input inside a record: csv.reader keeps what it read
        if (!field.empty() || state == IN_QUOTED_FIELD) {
          save_field();
          break;
        }
        return false;
      }
      int64_t end = line_end(pos);
      for (int64_t i = pos; i < end; ++i) {
        process(buf[i], false);
        if (over_limit) return false;
      }
      pos = end;
      process(0, true);
    } while (state != START_RECORD);
    return true;
  }

  // one line: up to and including '\n', '\r\n' or a lone '\r'
  int64_t line_end(int64_t from) const {
    int64_t end = from;
    while (end < len && buf[end] != '\n' && buf[end] != '\r') ++end;
    if (end < len) {
      if (buf[end] == '\r' && end + 1 < len && buf[end + 1] == '\n') ++end;
      ++end;
    }
    return end;
  }
};

int64_t line_of(const char* buf, int64_t offset) {
  int64_t n = 1;
  for (int64_t i = 0; i < offset; ++i) n += buf[i] == '\n';
  return n;
}

}  // namespace

extern "C" {

void* tsv_read_pairs(const char* buf, int64_t len, const char* col_user,
                     const char* col_item, int64_t field_limit) {
  auto* out = new Parsed();
  int64_t bad = first_invalid_utf8(
      reinterpret_cast<const unsigned char*>(buf), len);
  if (bad >= 0) {
    out->status = kNotUtf8;
    out->line = line_of(buf, bad);
    return out;
  }
  Reader r;
  r.buf = buf;
  r.len = len;
  r.field_limit = field_limit;
  int64_t record = 1;
  if (!r.next()) {
    out->status = r.over_limit ? kFieldLimit : kEmpty;
    out->line = record;
    return out;
  }
  out->header = r.fields;
  const auto& h = out->header;
  auto ui = std::find(h.begin(), h.end(), col_user) - h.begin();
  auto ai = std::find(h.begin(), h.end(), col_item) - h.begin();
  if (ui == static_cast<int64_t>(h.size()) ||
      ai == static_cast<int64_t>(h.size())) {
    out->status = kMissingColumn;
    out->line = record;
    return out;
  }
  // each distinct id once, numbered as it comes, kept in `store` (whose
  // strings never move)
  std::deque<std::string> store;
  std::unordered_map<std::string_view, uint32_t> umap, imap;
  std::vector<std::string_view> ulist, ilist;
  std::vector<uint32_t> tu, ti;
  auto intern = [&](std::string& s, auto& map, auto& list) {
    auto it = map.find(s);
    if (it != map.end()) return it->second;
    std::string_view kept = store.emplace_back(std::move(s));
    auto id = static_cast<uint32_t>(list.size());
    map.emplace(kept, id);
    list.push_back(kept);
    return id;
  };
  while (true) {
    ++record;
    if (!r.next()) {
      if (r.over_limit) {
        out->status = kFieldLimit;
        out->line = record;
        return out;
      }
      break;
    }
    if (r.fields.empty()) continue;
    if (r.fields.size() != h.size()) {
      out->status = kFieldCount;
      out->line = record;
      out->expected = static_cast<int64_t>(h.size());
      out->got = static_cast<int64_t>(r.fields.size());
      return out;
    }
    tu.push_back(intern(r.fields[ui], umap, ulist));
    ti.push_back(intern(r.fields[ai], imap, ilist));
  }
  // string order of the distinct ids, then the rows sorted by the pair
  // of ranks: the (user, item) string order
  auto ranks = [](const std::vector<std::string_view>& list) {
    std::vector<uint32_t> order(list.size()), rank(list.size());
    for (uint32_t k = 0; k < order.size(); ++k) order[k] = k;
    std::sort(order.begin(), order.end(),
              [&](uint32_t a, uint32_t b) { return list[a] < list[b]; });
    for (uint32_t k = 0; k < order.size(); ++k) rank[order[k]] = k;
    return std::make_pair(order, rank);
  };
  auto [u_order, u_rank] = ranks(ulist);
  auto [i_order, i_rank] = ranks(ilist);
  std::vector<uint64_t> keys(tu.size());
  for (size_t k = 0; k < keys.size(); ++k)
    keys[k] = static_cast<uint64_t>(u_rank[tu[k]]) << 32 | i_rank[ti[k]];
  std::sort(keys.begin(), keys.end());
  // users first appear in string order; items as the sorted rows reach them
  out->user_ids.reserve(ulist.size());
  for (auto k : u_order) out->user_ids.emplace_back(ulist[k]);
  std::vector<int32_t> item_id(ilist.size(), -1);
  out->user.resize(keys.size());
  out->item.resize(keys.size());
  for (size_t k = 0; k < keys.size(); ++k) {
    auto ir = static_cast<uint32_t>(keys[k]);
    if (item_id[ir] < 0) {
      item_id[ir] = static_cast<int32_t>(out->item_ids.size());
      out->item_ids.emplace_back(ilist[i_order[ir]]);
    }
    out->user[k] = static_cast<int32_t>(keys[k] >> 32);
    out->item[k] = item_id[ir];
  }
  return out;
}

static Parsed* as_parsed(void* h) { return static_cast<Parsed*>(h); }

int32_t tsv_status(void* h) { return as_parsed(h)->status; }

// line, expected, got
void tsv_error(void* h, int64_t* out) {
  out[0] = as_parsed(h)->line;
  out[1] = as_parsed(h)->expected;
  out[2] = as_parsed(h)->got;
}

int64_t tsv_n_rows(void* h) { return as_parsed(h)->user.size(); }

void tsv_copy_codes(void* h, int32_t* user_out, int32_t* item_out) {
  auto* p = as_parsed(h);
  std::memcpy(user_out, p->user.data(), p->user.size() * sizeof(int32_t));
  std::memcpy(item_out, p->item.data(), p->item.size() * sizeof(int32_t));
}

// which: 0 the users, 1 the items, 2 the header's fields
int64_t tsv_n_strings(void* h, int32_t which) {
  auto* p = as_parsed(h);
  return which == 0 ? p->user_ids.size()
         : which == 1 ? p->item_ids.size() : p->header.size();
}

// the bytes tsv_copy_strings writes
int64_t tsv_strings_bytes(void* h, int32_t which) {
  auto* p = as_parsed(h);
  int64_t n = 0;
  for (auto& s : which == 0 ? p->user_ids
                 : which == 1 ? p->item_ids : p->header)
    n += static_cast<int64_t>(s.size()) + 1;
  return n;
}

// the strings into `out`, each followed by '\n', and where each starts
// into `offsets` (n + 1 entries: the last is the end)
void tsv_copy_strings(void* h, int32_t which, char* out, int64_t* offsets) {
  auto* p = as_parsed(h);
  int64_t at = 0;
  size_t k = 0;
  auto put = [&](const std::string& s) {
    offsets[k++] = at;
    std::memcpy(out + at, s.data(), s.size());
    at += static_cast<int64_t>(s.size());
    out[at++] = '\n';
  };
  for (auto& s : which == 0 ? p->user_ids
                 : which == 1 ? p->item_ids : p->header)
    put(s);
  offsets[k] = at;
}

void tsv_free(void* h) { delete as_parsed(h); }

}  // extern "C"
