// GBNF grammar matcher: parse -> pushdown automaton over Unicode codepoints ->
// per-state allowed-token bitmasks (a copy of the JAX package's
// native/grammar.cpp; the port keeps its own, built by native/__init__.py).
//
// It runs on the host. Two products feed grammar-constrained sampling:
// - per step, a [ceil(V/8)]-byte allowed-token bitmask of the live parse
//   state (gm_state_mask), which the sampler applies on the device;
// - once per grammar, the dense automaton tables of every token-reachable
//   state (gm_table_build), which live on the device so the fused decode
//   loops gather each step's mask row and advance the state themselves.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libgrammar.so grammar.cpp
//
// GBNF subset (what a JSON-schema or tool-call grammar generator emits):
//   rule ::= production        # alternation |, groups (), postfix * + ?
//   literals "..." (with \" \\ \n \r \t \xHH \uHHHH escapes)
//   char classes [a-z0-9] / negated [^"\\] (same escapes)
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <vector>

namespace {

struct CharRange { uint32_t lo, hi; };

struct Element {
  enum Type : uint8_t { CHAR, CHAR_NOT, RULE, END } type;
  std::vector<CharRange> ranges;  // CHAR / CHAR_NOT
  int rule = -1;                  // RULE
};

using Seq = std::vector<Element>;  // END-terminated

struct Rule { std::vector<Seq> alts; };

// ----------------------------------------------------------------- utf8

// decode next codepoint from s[i..]; returns false on invalid/truncated
bool utf8_next(const std::string& s, size_t& i, uint32_t& cp) {
  if (i >= s.size()) return false;
  uint8_t c = s[i];
  int extra;
  if (c < 0x80) { cp = c; extra = 0; }
  else if ((c >> 5) == 0x6) { cp = c & 0x1f; extra = 1; }
  else if ((c >> 4) == 0xe) { cp = c & 0x0f; extra = 2; }
  else if ((c >> 3) == 0x1e) { cp = c & 0x07; extra = 3; }
  else return false;
  if (i + extra >= s.size()) return false;
  for (int k = 1; k <= extra; k++) {
    uint8_t cc = s[i + k];
    if ((cc >> 6) != 0x2) return false;
    cp = (cp << 6) | (cc & 0x3f);
  }
  i += extra + 1;
  return true;
}

// ----------------------------------------------------------------- parser

struct Parser {
  std::string src;
  size_t pos = 0;
  std::map<std::string, int> rule_ids;
  std::vector<Rule> rules;
  std::string err;

  int rule_id(const std::string& name) {
    auto it = rule_ids.find(name);
    if (it != rule_ids.end()) return it->second;
    int id = (int)rules.size();
    rule_ids[name] = id;
    rules.emplace_back();
    return id;
  }

  void ws() {
    while (pos < src.size()) {
      char c = src[pos];
      if (c == '#') { while (pos < src.size() && src[pos] != '\n') pos++; }
      else if (c == ' ' || c == '\t' || c == '\r' || c == '\n') pos++;
      else break;
    }
  }
  // whitespace that does NOT cross into the next rule definition
  void ws_inline() {
    while (pos < src.size()) {
      char c = src[pos];
      if (c == ' ' || c == '\t') { pos++; continue; }
      if (c == '\r' || c == '\n') {
        // lookahead: next non-space line starting with name ::= ends the rule
        size_t save = pos;
        while (pos < src.size() && (src[pos] == '\n' || src[pos] == '\r' ||
                                    src[pos] == ' ' || src[pos] == '\t'))
          pos++;
        size_t name_end = pos;
        while (name_end < src.size() &&
               (isalnum((uint8_t)src[name_end]) || src[name_end] == '-' ||
                src[name_end] == '_'))
          name_end++;
        size_t j = name_end;
        while (j < src.size() && (src[j] == ' ' || src[j] == '\t')) j++;
        if (name_end > pos && j + 2 < src.size() && src[j] == ':' &&
            src[j + 1] == ':' && src[j + 2] == '=') {
          pos = save;  // next rule definition: stop
          return;
        }
        continue;  // wrapped production line
      }
      break;
    }
  }

  bool name(std::string& out) {
    size_t start = pos;
    while (pos < src.size() && (isalnum((uint8_t)src[pos]) ||
                                src[pos] == '-' || src[pos] == '_'))
      pos++;
    if (pos == start) return false;
    out = src.substr(start, pos - start);
    return true;
  }

  bool escape(uint32_t& cp) {
    if (pos >= src.size()) return false;
    char c = src[pos++];
    switch (c) {
      case 'n': cp = '\n'; return true;
      case 'r': cp = '\r'; return true;
      case 't': cp = '\t'; return true;
      case '"': case '\\': case '/': case '[': case ']': case '^': case '-':
        cp = (uint32_t)(uint8_t)c; return true;
      case 'x': case 'u': case 'U': {
        int n = c == 'x' ? 2 : (c == 'u' ? 4 : 8);
        cp = 0;
        for (int k = 0; k < n && pos < src.size(); k++) {
          char h = src[pos];
          int v = (h >= '0' && h <= '9') ? h - '0'
                : (h >= 'a' && h <= 'f') ? h - 'a' + 10
                : (h >= 'A' && h <= 'F') ? h - 'A' + 10 : -1;
          if (v < 0) break;
          cp = cp * 16 + v;
          pos++;
        }
        return true;
      }
      default: cp = (uint32_t)(uint8_t)c; return true;
    }
  }

  bool literal(Seq& seq) {  // after opening "
    while (pos < src.size() && src[pos] != '"') {
      uint32_t cp;
      if (src[pos] == '\\') { pos++; if (!escape(cp)) return false; }
      else { size_t p = pos; if (!utf8_next(src, p, cp)) return false; pos = p; }
      Element e; e.type = Element::CHAR; e.ranges.push_back({cp, cp});
      seq.push_back(std::move(e));
    }
    if (pos >= src.size()) return false;
    pos++;  // closing "
    return true;
  }

  bool char_class(Element& e) {  // after opening [
    e.type = Element::CHAR;
    if (pos < src.size() && src[pos] == '^') { e.type = Element::CHAR_NOT; pos++; }
    while (pos < src.size() && src[pos] != ']') {
      uint32_t lo;
      if (src[pos] == '\\') { pos++; if (!escape(lo)) return false; }
      else { size_t p = pos; if (!utf8_next(src, p, lo)) return false; pos = p; }
      uint32_t hi = lo;
      if (pos + 1 < src.size() && src[pos] == '-' && src[pos + 1] != ']') {
        pos++;
        if (src[pos] == '\\') { pos++; if (!escape(hi)) return false; }
        else { size_t p = pos; if (!utf8_next(src, p, hi)) return false; pos = p; }
      }
      e.ranges.push_back({lo, hi});
    }
    if (pos >= src.size()) return false;
    pos++;  // closing ]
    return true;
  }

  // wrap element(s) for postfix operator via an auxiliary rule
  int aux_rule(Rule&& r) {
    int id = (int)rules.size();
    rules.push_back(std::move(r));
    return id;
  }

  void apply_postfix(Seq& seq, char op) {
    // take last element E of seq
    Element e = seq.back();
    seq.pop_back();
    Seq unit{e};
    unit.push_back({Element::END, {}, -1});
    if (op == '?') {
      Rule r;
      Seq a{e}; a.push_back({Element::END, {}, -1});
      r.alts.push_back(std::move(a));
      r.alts.push_back({{Element::END, {}, -1}});
      int id = aux_rule(std::move(r));
      Element ref; ref.type = Element::RULE; ref.rule = id;
      seq.push_back(ref);
      return;
    }
    // star: S ::= E S | ε ; plus: E S
    Rule r;
    int id = (int)rules.size();
    Seq a{e};
    Element self; self.type = Element::RULE; self.rule = id;
    a.push_back(self);
    a.push_back({Element::END, {}, -1});
    r.alts.push_back(std::move(a));
    r.alts.push_back({{Element::END, {}, -1}});
    aux_rule(std::move(r));
    if (op == '+') seq.push_back(e);
    Element ref; ref.type = Element::RULE; ref.rule = id;
    seq.push_back(ref);
  }

  // parse a sequence of items until | ) or end-of-production
  bool sequence(Seq& seq);

  bool group(int& out_rule) {  // after ( : alternation until )
    Rule r;
    for (;;) {
      Seq s;
      if (!sequence(s)) return false;
      s.push_back({Element::END, {}, -1});
      r.alts.push_back(std::move(s));
      ws_inline();
      if (pos < src.size() && src[pos] == '|') { pos++; continue; }
      break;
    }
    if (pos >= src.size() || src[pos] != ')') return false;
    pos++;
    out_rule = aux_rule(std::move(r));
    return true;
  }

  bool production(int rid) {
    // NOTE: sequence() may push auxiliary rules (reallocating `rules`), so
    // never hold a Rule& across it — collect alts locally, assign by index.
    std::vector<Seq> alts;
    for (;;) {
      Seq s;
      if (!sequence(s)) return false;
      s.push_back({Element::END, {}, -1});
      alts.push_back(std::move(s));
      ws_inline();
      if (pos < src.size() && src[pos] == '|') { pos++; continue; }
      break;
    }
    for (auto& a : alts) rules[rid].alts.push_back(std::move(a));
    return true;
  }

  bool parse() {
    ws();
    while (pos < src.size()) {
      std::string n;
      if (!name(n)) { err = "expected rule name @" + std::to_string(pos); return false; }
      ws_inline();
      if (pos + 2 >= src.size() || src.compare(pos, 3, "::=") != 0) {
        err = "expected ::= after " + n;
        return false;
      }
      pos += 3;
      if (!production(rule_id(n))) {
        err = "bad production for " + n + (err.empty() ? "" : (": " + err));
        return false;
      }
      ws();
    }
    return true;
  }
};

bool Parser::sequence(Seq& seq) {
  for (;;) {
    ws_inline();
    if (pos >= src.size()) break;
    char c = src[pos];
    if (c == '|' || c == ')') break;
    if (c == '"') {
      pos++;
      if (!literal(seq)) { err = "bad literal"; return false; }
    } else if (c == '[') {
      pos++;
      Element e;
      if (!char_class(e)) { err = "bad char class"; return false; }
      if (e.ranges.empty() && e.type == Element::CHAR) { err = "empty class"; return false; }
      seq.push_back(std::move(e));
    } else if (c == '(') {
      pos++;
      int gid;
      if (!group(gid)) { err = "bad group"; return false; }
      Element ref; ref.type = Element::RULE; ref.rule = gid;
      seq.push_back(ref);
    } else if (isalnum((uint8_t)c) || c == '-' || c == '_') {
      std::string n;
      name(n);
      Element ref; ref.type = Element::RULE; ref.rule = rule_id(n);
      seq.push_back(ref);
    } else {
      break;
    }
    // postfix operators
    if (pos < src.size() && (src[pos] == '*' || src[pos] == '+' || src[pos] == '?')) {
      if (seq.empty()) { err = "postfix without operand"; return false; }
      char op = src[pos++];
      apply_postfix(seq, op);
    }
  }
  return true;
}

// ----------------------------------------------------------------- PDA

struct Grammar {
  std::vector<Rule> rules;
  int root = -1;
  std::vector<std::vector<uint32_t>> tok_cps;  // codepoints per vocab token
  std::vector<uint8_t> tok_valid;
};

using Stack = std::vector<const Element*>;  // top = back()

bool char_matches(const Element& e, uint32_t cp) {
  bool in = false;
  for (const auto& r : e.ranges)
    if (cp >= r.lo && cp <= r.hi) { in = true; break; }
  return e.type == Element::CHAR ? in : !in;
}

// Stack-entry convention (llama.cpp grammar style): an entry is a pointer to
// an element WITHIN an END-terminated sequence; matching it continues with
// pos+1 at consumption time. expand() rewrites stacks until every top is a
// terminal char element (or the stack is empty = completed parse).
void expand(const Grammar& g, Stack stack, std::set<Stack>& out, int depth = 0) {
  if (depth > 512) return;  // runaway-recursion guard
  if (stack.empty()) { out.insert(stack); return; }
  const Element* top = stack.back();
  if (top->type == Element::CHAR || top->type == Element::CHAR_NOT) {
    out.insert(stack);
    return;
  }
  if (top->type == Element::RULE) {
    stack.pop_back();
    Stack base = std::move(stack);
    if ((top + 1)->type != Element::END) base.push_back(top + 1);
    for (const auto& alt : g.rules[top->rule].alts) {
      Stack s = base;
      if (alt[0].type != Element::END) s.push_back(&alt[0]);
      expand(g, std::move(s), out, depth + 1);
    }
    return;
  }
  // END shouldn't appear on stacks
}

// after consuming the terminal at `pos`, continue with pos+1 then expand
void advance_past(const Grammar& g, Stack stack, const Element* pos,
                  std::set<Stack>& out) {
  if ((pos + 1)->type != Element::END) stack.push_back(pos + 1);
  expand(g, std::move(stack), out);
}

struct State {
  const Grammar* g;
  std::set<Stack> stacks;

  bool accept_cp(uint32_t cp) {
    std::set<Stack> next;
    for (const auto& st : stacks) {
      if (st.empty()) continue;  // completed parse can't consume more
      const Element* top = st.back();
      if (!char_matches(*top, cp)) continue;
      Stack s = st;
      s.pop_back();
      advance_past(*g, std::move(s), top, next);
    }
    if (next.empty()) return false;
    stacks.swap(next);
    return true;
  }

  bool accept_token(const std::vector<uint32_t>& cps) {
    // trial on a copy
    State trial = *this;
    for (uint32_t cp : cps)
      if (!trial.accept_cp(cp)) return false;
    return true;
  }

  bool done() const {
    for (const auto& st : stacks)
      if (st.empty()) return true;
    return false;
  }
  bool can_continue() const {
    for (const auto& st : stacks)
      if (!st.empty()) return true;
    return false;
  }
};

}  // namespace

// ----------------------------------------------------------------- C API

extern "C" {

Grammar* gm_compile(const char* text, char* errbuf, int errlen) {
  Parser p;
  p.src = text;
  if (!p.parse()) {
    if (errbuf && errlen > 0) {
      strncpy(errbuf, p.err.c_str(), errlen - 1);
      errbuf[errlen - 1] = 0;
    }
    return nullptr;
  }
  auto it = p.rule_ids.find("root");
  if (it == p.rule_ids.end()) {
    if (errbuf) strncpy(errbuf, "no root rule", errlen - 1);
    return nullptr;
  }
  auto* g = new Grammar();
  g->rules = std::move(p.rules);
  g->root = it->second;
  return g;
}

// vocab: concatenated UTF-8 token texts + offsets[n+1]
int gm_set_vocab(Grammar* g, const char* blob, const int64_t* offsets, int n) {
  g->tok_cps.assign(n, {});
  g->tok_valid.assign(n, 0);
  for (int i = 0; i < n; i++) {
    std::string t(blob + offsets[i], blob + offsets[i + 1]);
    if (t.empty()) continue;
    std::vector<uint32_t> cps;
    size_t j = 0;
    bool ok = true;
    while (j < t.size()) {
      uint32_t cp;
      if (!utf8_next(t, j, cp)) { ok = false; break; }
      cps.push_back(cp);
    }
    if (ok && !cps.empty()) {
      g->tok_cps[i] = std::move(cps);
      g->tok_valid[i] = 1;
    }
  }
  return 0;
}

State* gm_state_new(Grammar* g) {
  auto* s = new State();
  s->g = g;
  std::set<Stack> out;
  for (const auto& alt : g->rules[g->root].alts) {
    Stack st;
    if (alt[0].type != Element::END) st.push_back(&alt[0]);
    expand(*g, std::move(st), out);
  }
  s->stacks = std::move(out);
  return s;
}

State* gm_state_clone(State* s) { return new State(*s); }

// advance with a token's codepoints; 1 on success, 0 reject
int gm_state_accept_token(State* s, int token_id) {
  if (token_id < 0 || token_id >= (int)s->g->tok_cps.size() ||
      !s->g->tok_valid[token_id])
    return 0;
  const auto& cps = s->g->tok_cps[token_id];
  State trial = *s;
  for (uint32_t cp : cps)
    if (!trial.accept_cp(cp)) return 0;
  *s = std::move(trial);
  return 1;
}

// fill bitmask (LSB-first per byte) of tokens acceptable from this state
int gm_state_mask(State* s, uint8_t* bits, int nbytes) {
  memset(bits, 0, nbytes);
  int n = (int)s->g->tok_cps.size();
  for (int i = 0; i < n && i / 8 < nbytes; i++) {
    if (!s->g->tok_valid[i]) continue;
    if (s->accept_token(s->g->tok_cps[i]))
      bits[i >> 3] |= (uint8_t)(1u << (i & 7));
  }
  return 0;
}

int gm_state_done(State* s) { return s->done() ? 1 : 0; }
int gm_state_can_continue(State* s) { return s->can_continue() ? 1 : 0; }
int gm_state_stack_count(State* s) { return (int)s->stacks.size(); }

// Enumerate every automaton state reachable from the initial state by
// whole-token transitions (BFS with exact dedup on the stack-set identity)
// and emit the dense device tables:
//   masks     [cap, words] u32  LSB-first bit t = token t acceptable
//   trans     [cap, n]     i32  next state index, -1 where the mask is 0
//   accepting [cap]        u8   done() — a completed parse exists here
// State 0 is the initial state. Returns the state count, or -1 when the
// reachable set exceeds `cap` (recursive grammars with unbounded nesting
// never close; callers fall back to the per-token host matcher).
int gm_table_build(Grammar* g, int cap, uint32_t* masks, int words,
                   int32_t* trans, uint8_t* accepting) {
  int n = (int)g->tok_cps.size();
  if (cap <= 0 || n <= 0) return -1;
  std::map<std::set<Stack>, int> index;
  std::vector<State> states;
  {
    State* init = gm_state_new(g);
    states.push_back(*init);
    delete init;
  }
  index[states[0].stacks] = 0;
  for (size_t i = 0; i < states.size(); i++) {
    State cur = states[i];  // copy: states reallocs under push_back below
    uint32_t* mrow = masks + i * (size_t)words;
    int32_t* trow = trans + i * (size_t)n;
    memset(mrow, 0, (size_t)words * sizeof(uint32_t));
    for (int t = 0; t < n; t++) trow[t] = -1;
    accepting[i] = cur.done() ? 1 : 0;
    for (int t = 0; t < n; t++) {
      if (!g->tok_valid[t]) continue;
      State trial = cur;
      bool ok = true;
      for (uint32_t cp : g->tok_cps[t])
        if (!trial.accept_cp(cp)) { ok = false; break; }
      if (!ok) continue;
      mrow[t >> 5] |= (1u << (t & 31));
      auto it = index.find(trial.stacks);
      int nxt;
      if (it != index.end()) {
        nxt = it->second;
      } else {
        nxt = (int)states.size();
        if (nxt >= cap) return -1;
        index[trial.stacks] = nxt;
        states.push_back(trial);
      }
      trow[t] = nxt;
    }
  }
  return (int)states.size();
}

void gm_state_free(State* s) { delete s; }
void gm_free(Grammar* g) { delete g; }

}  // extern "C"
